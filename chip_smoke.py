#!/usr/bin/env python3
"""Drive the port's erasure-coded data path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build      the CUDA kernels from ``ceph_tpu_torch/csrc`` (``sm_90a``)
              into ``ceph_tpu_torch/_build/``;
2. gf256      the GF(2^8) product kernel (K1) against its plain PyTorch
              version on the card, bit for bit: (R, k) in {(4, 8), (2,
              4), (3, 3), (8, 8) recovery}, ragged widths, a nonzero
              seed, donation, a row-slice output, one 8 x 1 Mi batch;
              then every (R, k) bucket edge in {1, 4, 5, 8, 9, 16, 17,
              32}^2 at a 16-byte-aligned width, a ragged one, a 4-byte-
              aligned row slice and an out= row slice, both seeds and
              both doubling variants, and donation at 8, 17 and 32;
3. crc32c     the segment-parallel row CRC-32C kernel against its plain
              version: lengths 0..4096 and 512 KiB, unaligned rows,
              chained inits, multi-job ``crc32c_rows`` at column offsets,
              rows ending on and beside the kernel's segment and lane-piece
              boundaries at odd offsets, the 2 x 12 x 512 KiB main batch;
4. gf2        both GF(2) bit-matrix kernels against the plain version,
              bit for bit, each operand through the kernel its structure
              picks (the XOR kernel for every jerasure operand, the
              popcount kernel for shec's): cauchy_good k=8 m=4 encode
              [256, 512] and decode [512, 512], shec k=8 m=4 c=3's [24, 64]
              and [24, 24], liberation and a K=96 decode, ragged widths,
              3-job packet batches of unequal odd widths for the encode and
              decode operands of five techniques (w 4, 6, 7, 8) and for
              shec's, random operands on the popcount (tensor-core)
              kernel in each K bucket (16, 32, 64, 128), one full-width
              coalesced batch;
5. gf256i     the interleaved GF(2^8) kernel (K2, K1's body and operand
              with an interleaved index) against its plain version, bit
              for bit: (R, k) in {(4, 8), (2, 4), (3, 3), (8, 8)
              recovery} at T in {128, 4096} over every tile that divides
              T and both doubling variants, and k=8 at T = 65536 (256
              MiB); then every (R, k) bucket edge in {1, 4, 5, 8, 9, 16,
              17, 32}^2 at T 257 and 4096, both seeds and both doubling
              variants, the launch count moving by the operand's row
              blocks (two past 16 x 16); the planar planes entry (K1)
              likewise, and the two layouts through a transpose;
6. main       ``isa reed_sol_van k=8 m=4`` with a 1 MiB stripe (chunk 128
              KiB): 256 seeded 4 MiB objects (1 GiB) written from 8
              threads through ``StripeBatchQueue.encode_crc_async``
              (every CRC held against the plain CRC of the stored
              shard), then read back degraded through
              ``decode_data_async`` with shards 6, 7, 10, 11 lost, byte
              for byte;
6a. mesh     ``main``'s workload at full width through
              ``StripeBatchQueue(mesh=MeshCompute([dev] * 8))``, a 4 x 2
              grid of cells on the one card (``gpu/meshio.py``): each
              coalesced ``encp`` batch through ``encode_scatter`` (K1 a
              cell over its column slice and its two coding rows), then
              the CRC kernel over the batch; each ``dec`` batch through
              ``recovery_gather`` (K1 a cell, four rows each); every batch
              counted in ``mesh_batches``, every CRC and coding byte equal
              to ``main``'s, every read exact; each object's 12 stored
              shards folded through ``scrub_digest`` (one ``mesh_digest``
              launch a stripe row), each digest equal to
              ``mesh_digest_plain`` on the card and to a one-cell mesh's,
              a flipped byte changing it; ``encode_scatter(keep_device=
              True)`` into ``recovery_gather`` on card tensors, exact;
6b. core     the core host layer on that path (``ceph_tpu_torch/core``):
              the host CRC-32C (``core.crc``) equal to the card's CRC
              kernel on a main batch's rows (2 jobs x 12 shards x 512
              KiB, and x 128 KiB) and on 1 B, 4 KiB + 3 B and 4 MiB
              buffers, with its host rate at 4 MiB; a write and degraded
              read of 32 x 4 MiB (isa k=8 m=4, shards 6, 7, 10, 11 lost)
              through a queue built under lockdep, bytes and CRCs exact,
              no LockOrderError; ``queue.batch.dispatch`` armed with
              ``error`` and ``once`` failing exactly one batch's jobs,
              then 8 writes exact; and a Context's admin socket answering
              ``device compile dump`` with those checks' launches per
              kernel and the queue's batch count;
6c. wire     client ops through the PG on the wire and in the stores
              (``ceph_tpu_torch/osd/pg.py`` over ``osd/backend.py``, with
              ``msg``, ``auth``, ``store``, the OSD messages and PG log,
              ``gpu/staging`` DeviceBuf), under lockdep: the primary
              ``osd.0`` and four peers ``osd.1`` .. ``osd.4``, each a
              ``PG`` over its own MemStore behind a ``PhaseOSD`` host and
              a messenger (127.0.0.1, cephx authorizers bound to the
              dialed address, frame CRCs on), shard s on osd s % 5, the
              primary ``STATE_ACTIVE``; the primary's queue built under
              lockdep, its staging pool set to 16 slots of 4 MiB; 32
              seeded 4 MiB objects (isa k=8 m=4, 1 MiB stripe) each sent
              by ``client.4100`` as one ``WRITEFULL`` ``MOSDOp``, which
              osd.0's op threads hand to ``PG.do_op``: ``_do_write``
              stages it (``DeviceBuf.stage``), mints its version under
              the PG lock and submits it; the queue's ``encp`` batch (K1
              and the CRC kernel) codes it, each shard's ``hinfo`` takes
              the card's CRC, the primary's three shards go into its
              store through ``op_payload`` and each peer's PG gets one
              ``MECSubWriteVec`` (``handle_sub_write_vec``), then the
              slot is sealed and the ``MOSDOpReply`` comes at the commit;
              checked: every reply 0, every write staged and none
              degraded by a pool timeout, no op in flight, an ``encp``
              batch wider than one write (the first batch held 200 ms at
              ``queue.batch.dispatch``, so the writes in flight queue up
              behind it), no unsanctioned host copy, each
              parity handle fetched once, every slot back and at most 16
              in use, the primary's shards applied through
              ``op_payload`` before each seal, no host CRC in the
              backend's write, 32 ordered log entries on every holder and
              every PG's ``last_update`` and log head at version 32,
              every stored shard read back through its extent seals with
              the host CRC and its ``hinfo`` CRC equal to the card's CRC,
              and the ``devbuf`` check (object 0's parity by K1 on a CUDA
              tensor, wrapped as that tensor, reads back as the queue's
              parity with one counted fetch); a messenger without an
              authorizer refused and never delivered; then osd.4 shut
              down and marked down (shards 4, 9), the primary
              ``STATE_DEGRADED`` with its object-context cache emptied,
              and ``store.corrupt_chunk`` armed for shard 6 on osd.1; one
              ``READ`` ``MOSDOp`` an object goes ``do_op`` ->
              ``_ec_read_object``: ``ChunkGather`` reads the primary's
              shards and sends one ``MECSubRead`` a remote shard
              (``handle_sub_read``; the rotten one answers ``ECRC``
              without data, counted once an object by
              ``_note_read_verify_fail``), and ``reconstruct_async``
              decodes every object through the queue's ``dec`` kind (K1,
              one job an object) from the nine survivors, byte for byte;
6d. recovery  on the wire phase's PGs: osd.4 back on a new messenger,
              the primary's shards 0, 5 and 10 of all 32 objects removed
              in one transaction and marked in ``pg.missing`` at their
              log versions, and ``PG.recovery_engine().recover`` rebuilds
              them: one ``MECSubReadVec`` per peer per round (Ceph's
              default window of 3 objects), shard 6 answering ``ECRC``,
              so exactly k = 8 sources, reconstructs through the queue's
              ``dec`` kind (K1); every rebuilt shard and its ``hinfo``
              equal to what stood before the loss, ``missing`` and
              ``unfound`` empty; the wall and objects per second;
6e. scrub    on the wire phase's PGs after the recovery, shard 6 still
              rotten on osd.1: ``client.4100`` sends ``OP_CALL``
              ``MOSDOp``s on one object through ``do_op`` (``lock.lock``,
              ``lock.get_info``, a second ``lock.lock`` by another owner
              answered ``EBUSY``, ``version.set``, ``version.check``),
              each reply's result and out bytes checked, the two cls
              writes re-encoded (K1) and sent to every peer, the object
              read back byte for byte; ``PG.scrub_engine().run``: a
              shallow pass (one ``MScrub`` a peer, metadata only) clean;
              a deep pass (``osd_scrub_auto_repair`` off: every shard
              gathered, one ``MECSubRead`` a remote shard, each chunk's
              decodes submitted together on the queue's ``dec`` kind, K1,
              and each object re-encoded and compared) naming shard 6 on
              all 32 objects, ``scrub_errors`` 32, the stamps row
              written and the cursor cleared; the failpoint disarmed and
              five shards marked with ``debug_inject_data_err`` (the
              primary's shard 0 and shards 1, 7, 8, 11 on three peers),
              ``run(deep=True, auto_repair=True)`` clean and
              ``scrub_errors`` 0, each repaired shard's bytes, ``hinfo``
              and ``_av`` as before the rot and its mark cleared (the
              primary's through its store, the peers' by ``MPGPush``),
              and a last deep pass clean;
6f. daemon   twelve port OSD daemons (``ceph_tpu_torch/osd/daemon.py``,
              one ``OSDService`` a shard, each over its own MemStore)
              on one ``OSDMap`` (``build_flat_cluster(12, hosts=12)``, an
              indep and a firstn rule; isa k=8 m=4 with a 1 MiB stripe,
              size 12, min_size 9, and a replicated pool of size 3, 8 PGs
              each), under lockdep: ``tpu_boot_warmup`` on, so each
              ``init`` runs ``DeviceWarmup`` (K1, the CRC kernel, K6 at
              every declared bucket) before its messengers serve; the map
              and address book to every daemon (``handle_osdmap``: one
              K6 launch a PG a call, timed), ``activate_pgs``,
              ``wait_pgs_settled``, heartbeats; ``client.4100`` sends 32
              x 4 MiB ``WRITEFULL`` ``MOSDOp``s to pool A and 16 x 64 KiB
              to pool B, each to its acting primary, whose ``ms_dispatch``
              queues it on the mclock workqueue into ``PG.do_op``
              (``encp``: K1 and the CRC); every stored shard equal to the
              plain encode with its ``hinfo`` the host CRC of it, every
              PG's ``last_update`` agreed by its holders, the client ops
              counted by each primary's ``osd.N.qos`` and kept in its op
              history; the primary of pool B's first PG shut down and
              marked down, every daemon re-peered, every object read
              back byte for byte (``_ec_read_object`` ->
              ``reconstruct_async``, K1); 8 + 4 objects rewritten while
              it is down, then it revives on its old store and catches up
              (the recovery engine on pool A, ``pull_from_peer`` on pool
              B), every shard on it equal to the plain encode and
              ``missing`` empty; one shard of object 0 marked with
              ``debug_inject_data_err`` and the primary's
              ``start_scrub_scheduler`` until the cluster log's
              ``deep-scrub`` ERR names it (``admitted_scrub`` counted);
              every daemon shut down and no thread it started left;
6g. cluster  the client over the daemons (``ceph_tpu_torch/client/``):
              twelve daemons booted as the daemon phase boots them, on a
              map of the same shape, under lockdep; one port
              ``RadosClient`` (``client.4200``, on the card)
              ``inject_osdmap``ed and handed every map refresh, whose
              objecter places each op (``_calc_target``: one K6 launch a
              send and a resend) and resends it on a map change and on
              its 1 s timer; 32 x 4 MiB ``IoCtx.aio_operate``
              ``WRITEFULL`` to pool A from 8 threads and 16 x 64 KiB to
              pool B, every stored shard equal to the plain encode with
              its ``hinfo`` the host CRC; 8 new pool-A objects in flight
              to the PGs one daemon leads when it shuts down and is
              marked down: every op answered 0 and one log entry a
              reqid; every object read back by ``IoCtx.read`` byte for
              byte (K1 ``dec``); one 64 MiB object through
              ``RadosStriper`` (1 MiB units, 4 wide, 4 MiB objects) read
              back whole and at an unaligned offset; the client and every
              daemon shut down and no thread left;
6h. clay     32 x 4 MiB through one clay k=8 m=4 d=11 PG over eleven
              hosts: write (``encp``), a shard repaired (``crep``), a
              degraded read (``cdec``), a deep scrub;
6i. vstart   the cluster a monitor quorum runs
              (``ceph_tpu_torch/vstart.py``, ``mon/``): three port
              ``Monitor``s on LSMStores and twelve port daemons on
              BlockStores under a temporary ``data_dir``, warmup on, under
              lockdep; the election and the boot through the mons timed
              apart, every daemon up in the leader's map; an isa k=8 m=4
              pool (1 MiB stripe) made by ``osd erasure-code-profile set``
              and ``osd pool create`` through the mons (each daemon's
              warmup resumed with its codec: K1); 8 x 4 MiB written by
              the port's ``RadosClient`` (``WRITEFULL`` one at a time:
              K6 placement, ``encp``), every stored shard equal to the
              plain encode with its ``hinfo`` the host CRC; ``pg
              deep-scrub`` relayed by the leader (its ``pg_to_up_acting``:
              K6) until the PG's stamp moves; the mgr
              (``ceph_tpu_torch/mgr/``) started with its dashboard, read
              over HTTP (``/api/status``, ``/api/pgs`` with every PG of
              the pool, ``/api/perf``, ``/metrics``), the port's
              ``ObjBencher`` on the pool (3 s of 1 MiB writes, 2 s of
              reads, from 2 threads: K6, K1, the CRC kernel) and six
              commands through the port's ``ceph`` dispatch; the leader
              mon shut down,
              a new leader elected, a ``config set`` committed through it
              on every live mon and 2 more objects written; the daemon
              holding data shard 1 of object 0's PG shut down and marked
              down from failure reports, the dashboard's health naming
              its ``OSD_DOWN`` (through the mons and through the mgr's
              feed of the new leader), every object read back byte for
              byte (``dec``: K1); the port's ``objectstore_tool`` exporting
              object 0's PG offline from the lost daemon's BlockStore
              (shard 1 equal to the plain encode's) and ``monstore_tool``
              reading the killed mon's paxos range offline; the killed
              mon restarted from its LSMStore directory at that version
              and every mon at the leader's version and map epoch; the
              cluster shut down and no thread left;
7. bitmatrix  the same 1 GiB write through ``jerasure k=8 m=4
              technique=cauchy_good``, read back degraded through
              ``codec.decode_array`` with shards 6, 7, 10, 11 lost (the
              XOR kernel on both, the popcount kernel on neither);
8. shec       the same through ``shec k=8 m=4 c=3``, read back with data
              shards 0, 1, 2 lost (the shec decode on the popcount
              kernel, two launches per object: contribution and solve);
9. lrc        ``lrc k=4 m=2 l=3``: 64 objects encoded, one chunk lost and
              rebuilt from its local group;
10. crush     CRUSH placement (K6, the rule walk, and K7, the staged
              sweeps over it) on the BASELINE map: build_flat_cluster(1024,
              hosts=64), chooseleaf firstn 3 type host, all reweights
              1.0.  sweep_device over 10,485,760 ids (chunk 2^19: 20
              stage-1 launches, one stage-2 and one exact), held row for
              row against the exact program in one call, and the share of
              draws the kernel settled on the exact path; the kernel
              against the plain walk on the card over the first 2^20 ids;
              3 distinct OSDs on 3 distinct hosts per row and the per-OSD
              spread; a rebalance (one host's 16 OSDs at weight 0, 8 OSDs
              at half weight: no placement on a weight-0 OSD, the share
              moved); the same map with every fourth OSD at weight
              0x20000, one timed compile_rule over 2^21 ids whose first
              2^20 rows equal the plain walk's (the exact draw and its
              reciprocal divide at scale); chooseleaf indep 12 (the isa
              k=8 m=4 pool) over 2^22 ids with no holes; the small maps of
              ``crush.samples`` at budgets 0, 1, 3; and ``crushtool
              --test`` over 2^20 ids with no bad mapping;
10b. placement  placement on the host (``ceph_tpu_torch/osd``, ``mgr``,
              ``tools/osdmaptool``) on the crush phase's map, with a
              replicated pool (size 3, ``chooseleaf firstn 0 type host``,
              16384 PGs) and an isa k=8 m=4 pool (size 12, ``chooseleaf
              indep 12 type host``, 4096 PGs), Ceph's guidance of about
              100 PGs per OSD: ``map_pgs`` on both pools (median of 3, one
              K6 launch a pool a call), every row equal to the same map
              decoded onto the CPU (the plain walk); ``pg_to_up_acting``
              on 512 seeded PGs a pool (one launch each) equal to the
              sweep's rows; host 5 down and out through an encoded
              Incremental (no out OSD up, untouched PGs keep their rows,
              the share of slots moved); the upmap balancer (max_deviation
              1.0, 64 moves) on both pools without raising the stddev and
              keeping each failure domain, its map carried by an
              Incremental into a clone that places the same; the
              crush-compat balancer (12 iterations) on pool 1; osdmaptool
              --createsimple 1024 --pg_num 16384, --test-map-pgs and
              --upmap on the card, and crushtool -d -i of that map's
              binary crush map;
11. ecbench   the device EC engine bench (``ceph_tpu_torch.tools.ecbench``)
              at its full sizes with a short calibration target: both
              engines pinned against the host oracle, the autotune over
              layout x tile x doubling variant at 16 MiB, encode and
              decode sweeps from 1 to 256 MiB, the small-stripe rates and
              the envelope; it is K2's path.

Each path zeroes the kernel launch counts just before its writes and
reads them just after, then likewise for its reads (the mesh phase
also around its digest step and its chained step; the core phase
zeroes them before its lockdep run and reads them after its failpoint
check; the wire phase's write half is its MOSDOp writes and commits, its
read half the MOSDOp reads with their sub-reads and reconstructs, the
recovery phase zeroes them just before the recovery window and reads
them just after, the scrub phase around each of its steps, and the
daemon phase around each of its steps: warmup, write, kill, read,
write_down, recover, scrub, and the cluster phase around each of its
steps: boot, write, failover, read, stripe, and the vstart phase around
each of its steps: boot, pool, write, relay, mgr, leader_loss, osd_loss,
mgr_health, read, objectstore_tool, monstore_tool, mon_restart; a map
refresh's K6 launches are read before and after it);
each
kernel of each
half must have run (for ecbench, K2 and K1: its loops capture one launch
per iteration in a CUDA graph and replay it, and the counts are of the
captured launches).  Then each kernel is timed at its path's batch
shape, beside its plain version and its bound: ``ms`` is device time per
launch from a CUDA graph of launches, ``call_ms`` the eager wrapper call
with CUDA events; the K1 and CRC rows carry their launches in the wire
phase's two halves, the recovery phase and each step of the scrub phase
(``wire_launches``), and, with the ``crush_rule`` row, each step of the
daemon phase and each of its map refreshes (``daemon_launches``) and
each step of the cluster phase (``cluster_launches``; the
``crush_rule`` row adds the objecter's ``_calc_target`` calls a step
and the refreshes' launches), each step of the vstart phase
(``vstart_launches``; the ``crush_rule`` row adds the client objecter's
``_calc_target`` calls a step and the relay command's launches), and
each step of the mesh phase (``mesh_launches``); the ``mesh_digest`` row times the digest kernel at
the digest step's [12, 512 Ki] and at [12, 64 Mi] beside
``x.sum(dtype=torch.int64)`` (``library_ms``); the
popcount row times both of
shec's read shapes
(``ms`` the contribution, ``solve_ms`` the solve).  The crush phase
zeroes the counts just before its main sweep and reads them just after
(22 ``crush_rule`` launches and nothing else); the ``crush_rule`` row
times the sweep's one-attempt launch over one 2^19-id chunk (``ms``),
the exact launch over it, the eager ``compile_rule`` call, and carries
the sweep's rate, stages and the exact program's time, its bound taken
from the draws and hashes the kernel counted in this run, and the
straw2 loop's ALU-pipe issue floor (its SASS per draw, 64 lanes a cycle
per SM at the card's top SM clock); it also carries the placement
phase's K6 launches (``placement_launches``, each step's counted between
zeroed counts) and its sweep ms per pool.  The K1, K2,
popcount and crush_rule rows carry ``sass``: registers, stack/local
bytes and SASS counts of their main instantiations, read from the built
library; the run fails unless the popcount kernel's SASS holds
tensor-core instructions.  Output, every number beside the card's
name and power limit: one line per phase, then the card line from
nvidia-smi, then the kernel table as one JSON line, then the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before doing anything.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32 rate, used for int32 ops
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core rate
SEED = 20261016
MiB = 1 << 20
ECBENCH_TARGET_S = 0.1  # seconds per calibrated bench call (its default: 0.5)
ECBENCH_CAP_S = 2.0
# CRUSH (K6, K7): the BASELINE map of bench.py:1762-1771 and the sweep
# size of Ceph's crushtool --test and ParallelPGMapper
CRUSH_OSDS, CRUSH_HOSTS = 1024, 64
CRUSH_IDS = 20 << 19        # 10,485,760 object ids
CRUSH_CHUNK = 1 << 19
CRUSH_HOLD = 1 << 20        # ids on which the kernel is held to the plain walk
CRUSH_EC_IDS = 1 << 22
CRUSH_MIXED_IDS = 1 << 21   # ids of the mixed-weight map's timed call
# integer ops of one straw2 draw, counted from csrc/crush.cu: hash32_3 (3
# seed XORs and 5 mixes of 9 sub-sub-shift-xor lines: 183), crush_ln (20),
# the 64-bit divide as one op, the compare and select (3); an is_out hash
# (hash32_2: 2 + 3 x 36 = 110) plus its mask and compare (2)
DRAW_OPS = 183 + 20 + 1 + 3
HASH_OPS = 110 + 2


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events.  Unlike
    :func:`event_ms` over eager calls, the Python of the wrapper (tens
    of microseconds a call) stays out of the time of a kernel that runs
    for less.  fn must allocate and synchronise nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):  # warm-up: operands to the card, attributes set
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * iters)


def rotating(torch, dev, g, rows: int, cols: int) -> list:
    """Seeded [rows, cols] buffers, enough of them to exceed the 50 MB L2
    together, so that a timing loop finds its inputs in HBM."""
    n = max(8, -(-(64 * MiB) // (rows * cols)))
    return [torch.randint(0, 256, (rows, cols), dtype=torch.uint8,
                          device=dev, generator=g) for _ in range(n)]


def gf_ops(mat: np.ndarray, words: int) -> int:
    """Integer ops of the SWAR product: per word column, one seed XOR
    per input row, six ops per doubling, one XOR per set coefficient
    bit."""
    need = np.bitwise_or.reduce(mat.astype(np.int64), axis=0)
    per = sum(1 + 6 * (max(int(c).bit_length(), 1) - 1) for c in need)
    per += int(np.unpackbits(mat.astype(np.uint8)).sum())
    return per * words


def bound(nbytes: int, ops: int, ops_per_s: float = INT_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def batch_shape(res: dict):
    """(jobs, columns) of the path's most common coalesced write batch:
    jobs side by side, padded to the queue's covering width."""
    from ceph_tpu_torch.gpu import shapebucket

    J = max(res["batch_jobs"].items(), key=lambda kv: (kv[1], kv[0]))[0]
    return J, shapebucket.covering(J * res["width"], 1)


# SASS opcodes that issue to the INT32 (ALU) pipe; IMAD goes to the FMA
# pipe and the U* opcodes to the uniform datapath
INT32_OPS = {"LOP3", "SHF", "IADD3", "ISETP", "LEA", "SEL", "PRMT", "IABS",
             "IMNMX", "POPC", "FLO", "BMSK", "PLOP3", "MOV"}


def kernel_sass(log) -> dict:
    """Registers, local-memory bytes and static SASS instruction counts of
    the kernels' main instantiations in the built library, read with
    cuobjdump: K1's 4 x 8 encode and 8 x 8 decode buckets and K2's
    interleaved 4 x 8, plain doubling (a thread owns one word column, so
    the kernel's count, prologue and guards included, is its count per
    word column); and K3's popcount kernel in each of its K buckets
    (``popcount_k16``, the m16n8k128 form, runs shec's reads; k32, k64
    and k128 take 1, 2 and 4 steps of m16n8k256), whose tensor-core
    instructions (``BMMA``, ``IMMA``) and ``POPC`` are counted too; and
    the CRUSH rule walk (K6, ``crush_rule``) with its straw2 loop."""
    from ceph_tpu_torch.ops import _build

    want = {("gf256", 4, 8, 0): "enc_4x8", ("gf256", 8, 8, 0): "dec_8x8",
            ("gf256", 4, 8, 1): "inter_4x8", ("gf2", 1, 1): "popcount_k16",
            ("gf2", 1, 0): "popcount_k32", ("gf2", 2, 0): "popcount_k64",
            ("gf2", 4, 0): "popcount_k128", ("crush",): "crush_rule"}
    popcount = ("popcount_k16", "popcount_k32", "popcount_k64",
                "popcount_k128")
    gf256_name = re.compile(
        r"gf256_matmul_kernelILi(\d+)ELi(\d+)ELb0ELb([01])E")
    gf2_name = re.compile(r"gf2_matmul_kernelILi(\d+)ELb([01])EE")
    tool, path = _build.cuda_bin("cuobjdump"), _build.lib()._name

    def dump(flag: str) -> str:
        return subprocess.run([tool, flag, path], capture_output=True,
                              text=True, timeout=300, check=True).stdout

    def which(line: str):
        f = gf256_name.search(line)
        if f:
            return want.get(("gf256", int(f[1]), int(f[2]), int(f[3])))
        f = gf2_name.search(line)
        if f:
            return want.get(("gf2", int(f[1]), int(f[2])))
        return want[("crush",)] if "crush_rule_kernel" in line else None

    out, cur = {}, None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = which(m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) .*LOCAL:(\d+)", line)
        if cur and m:
            out[cur] = {"regs": int(m[1]), "stack": int(m[2]),
                        "local": int(m[3]), "sass": 0, "int32": 0,
                        "lop3": 0, "bmma": 0, "imma": 0, "popc": 0}
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)")
    addr = re.compile(r"/\*([0-9a-f]{4,})\*/")
    cur, crush_ops = None, []
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = which(m.group(1))
            continue
        m = op.search(line) if cur in out else None
        if m and m[1] != "NOP":
            c = out[cur]
            c["sass"] += 1
            c["int32"] += m[1] in INT32_OPS
            for key in ("lop3", "bmma", "imma", "popc"):
                c[key] += m[1] == key.upper()
            if cur == "crush_rule":
                crush_ops.append((int(addr.search(line)[1], 16), m[1],
                                  line))
    out["crush_rule"].update(straw2_loop(crush_ops))
    require(set(out) == set(want.values())
            and all(c["sass"] for c in out.values()),
            f"cuobjdump found the main instantiations: {sorted(out)}")
    log("gf256 K1 and K2 SASS per word column (registers, stack/local "
        "bytes, instructions, INT32 pipe, LOP3): " + "; ".join(
            f"{k} {out[k]['regs']} regs, {out[k]['stack']}/"
            f"{out[k]['local']} B, {out[k]['sass']}, {out[k]['int32']}, "
            f"{out[k]['lop3']}" for k in ("dec_8x8", "enc_4x8", "inter_4x8")))
    log("gf2 popcount kernel SASS (registers, stack/local bytes, "
        "instructions, BMMA, IMMA, POPC): " + "; ".join(
            f"{k} {out[k]['regs']} regs, {out[k]['stack']}/"
            f"{out[k]['local']} B, {out[k]['sass']}, {out[k]['bmma']}, "
            f"{out[k]['imma']}, {out[k]['popc']}"
            for k in popcount))
    c = out["crush_rule"]
    require(c["straw2_hashes"] > 0, "cuobjdump found K6's straw2 loop")
    log(f"crush rule-walk kernel (K6) SASS: {c['regs']} registers, "
        f"{c['stack']}/{c['local']} B stack/local, {c['sass']} instructions; "
        f"the straw2 loop {c['straw2_sass']} instructions for "
        f"{c['straw2_hashes']} hash32_3, {c['straw2_alu']} on the ALU pipe, "
        f"{c['straw2_alu_per_draw']:.1f} a draw")
    # a fall back to LOP3/POPC code would compute the same bytes slower
    require(all(out[k]["bmma"] + out[k]["imma"] > 0 for k in popcount),
            "the popcount kernel runs on tensor cores (BMMA/IMMA in SASS)")
    return out


def straw2_loop(ops) -> dict:
    """The straw2 scan's loop in K6's SASS, from (address, opcode, line)
    triples: the smallest loop (a backward branch and its target) that
    holds a hash32_3 (its immediate 231232 = 0x38740) and a call (the
    exact draw, out of line).  Its instructions on the ALU pipe (INT32_OPS)
    over its hash32_3 count are the issue cost of one draw on the
    hash-order path, the exact path's call set-up included."""
    best = None
    for at, name, line in ops:
        tgt = re.search(r"BRA\s.*?(0x[0-9a-f]+)\s*;", line)
        if name != "BRA" or not tgt or int(tgt[1], 16) >= at:
            continue
        body = [o for o in ops if int(tgt[1], 16) <= o[0] <= at]
        hashes = sum("0x38740" in o[2] for o in body)
        if hashes and any(o[1] == "CALL" for o in body) and (
                best is None or len(body) < len(best[0])):
            best = (body, hashes)
    if best is None:
        return {"straw2_sass": 0, "straw2_hashes": 0, "straw2_alu": 0,
                "straw2_alu_per_draw": 0.0}
    body, hashes = best
    alu = sum(o[1] in INT32_OPS for o in body)
    return {"straw2_sass": len(body), "straw2_hashes": hashes,
            "straw2_alu": alu, "straw2_alu_per_draw": alu / hashes}


def phase_gf256(torch, dev, log) -> None:
    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.ec.codec import RSMatrixCodec
    from ceph_tpu_torch.ops import gf256

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(k, n):
        return torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                             generator=g)

    rec, _ = RSMatrixCodec(8, 4, matrices.isa_rs_vandermonde(8, 4),
                           device=dev).recovery_matrix([0, 1, 2, 3, 4, 5, 8, 9])
    cases = [("isa 4x8", matrices.isa_rs_vandermonde(8, 4)),
             ("cauchy 2x4", matrices.isa_cauchy(4, 2)),
             ("cauchy 3x3", matrices.isa_cauchy(3, 3)),
             ("recovery 8x8", rec)]
    checked = 0
    for name, mat in cases:
        R, k = mat.shape
        for n in (1, 4, 4099, 65536, 1000003):
            for seed in (0, 0xA5A5A5A5):
                x = rand(k, n)
                got = gf256.gf_matmul_bytes(mat, x, seed=seed)
                want = gf256.gf_matmul_bytes_plain(mat, x, seed=seed)
                require(torch.equal(got, want), f"gf256 {name} n={n} "
                        f"seed={seed:#x}")
                checked += 1
        if R == k:
            x = rand(k, 1 << 16)
            want = gf256.gf_matmul_bytes_plain(mat, x)
            ptr = x.data_ptr()
            got = gf256.gf_matmul_bytes(mat, x, donate=True)
            require(got.data_ptr() == ptr and torch.equal(got, want),
                    f"gf256 {name} donated in place")
            checked += 1
    mat = matrices.isa_rs_vandermonde(8, 4)
    full = rand(12, 1 << 16)
    want = gf256.gf_matmul_bytes_plain(mat, full[:8])
    gf256.gf_matmul_bytes(mat, full[:8], out=full[8:])
    require(torch.equal(full[8:], want), "gf256 into a row slice")
    x = rand(8, MiB)
    require(torch.equal(gf256.gf_matmul_bytes(mat, x),
                        gf256.gf_matmul_bytes_plain(mat, x)),
            "gf256 full width 8 x 1Mi")
    checked += 2
    # every row and column bucket edge of the kernel, random matrices: a
    # 16-byte-aligned width, a ragged width (word-padded copy), a
    # 4-byte-aligned row slice and an out= row slice of one batch, over
    # both seeds and both doubling variants; a matrix past 16 x 16 runs
    # as two launches
    rng = np.random.default_rng(SEED)
    edges = (1, 4, 5, 8, 9, 16, 17, 32)
    for R in edges:
        for k in edges:
            mat = rng.integers(0, 256, (R, k), dtype=np.uint8)
            nl = len(gf256.k1_operand(mat).blocks)
            base = rand(k, 4 * 4099 + 16)
            for what, x, seed, shift in (
                    ("aligned", rand(k, 1 << 16), 0xA5A5A5A5, False),
                    ("ragged", rand(k, 4099), 0, True),
                    ("4-byte slice", base[:, 4:4 + 4 * 4099], 0xA5A5A5A5,
                     True)):
                before = gf256.launches.value
                got = gf256.gf_matmul_bytes(mat, x, seed=seed,
                                            mul_shift=shift)
                require(gf256.launches.value - before == nl,
                        f"gf256 {R}x{k} {what}: {nl} launch(es) counted")
                require(torch.equal(got, gf256.gf_matmul_bytes_plain(
                    mat, x, seed=seed)), f"gf256 {R}x{k} {what} "
                    f"seed={seed:#x} mul_shift={shift}")
                checked += 1
            batch = rand(k + R, 4 * 4099)  # rows 4-byte aligned, not 16
            want = gf256.gf_matmul_bytes_plain(mat, batch[:k], seed=7)
            gf256.gf_matmul_bytes(mat, batch[:k], out=batch[k:], seed=7)
            require(torch.equal(batch[k:], want),
                    f"gf256 {R}x{k} into a row slice")
            checked += 1
    # donation: the main decode's shape, and the split 17 x 17 and 32 x 32
    # (staged through a scratch output), at aligned and ragged widths
    for d in (8, 17, 32):
        mat = rng.integers(0, 256, (d, d), dtype=np.uint8)
        for n in (1 << 16, 4 * 4099):
            x = rand(d, n)
            want = gf256.gf_matmul_bytes_plain(mat, x, seed=3)
            ptr = x.data_ptr()
            got = gf256.gf_matmul_bytes(mat, x, donate=True, seed=3,
                                        mul_shift=n != 1 << 16)
            require(got.data_ptr() == ptr and torch.equal(got, want),
                    f"gf256 {d}x{d} donated in place n={n}")
            checked += 1
    torch.cuda.synchronize()
    log(f"gf256: {checked} kernel calls bit-equal to the plain version "
        f"(every (R, k) bucket edge of {list(edges)}: aligned, ragged, "
        "4-byte row slices and out= slices, both seeds and doubling "
        "variants; donation at 8, 17 and 32)")


def phase_gf2(torch, dev, log) -> None:
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.ops import gf2_matmul as g2

    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rand(k, n):
        return torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                             generator=g)

    cg = codec_from_profile("plugin=jerasure k=8 m=4 technique=cauchy_good",
                            device=dev)
    enc = cg.operand(cg.coding_bits)
    dec = cg.operand(cg.recovery_bits([0, 1, 2, 3, 4, 5, 8, 9]))
    sh = codec_from_profile("plugin=shec k=8 m=4 c=3", device=dev)
    _, s_op, contrib_op = sh.solve_operands((0, 1, 2), tuple(range(3, 12)))
    lib = codec_from_profile("plugin=jerasure k=7 m=2 technique=liberation "
                             "w=7", device=dev)
    big = codec_from_profile("plugin=jerasure k=12 m=4 "
                             "technique=cauchy_good", device=dev)
    cases = [("cauchy_good encode", enc), ("cauchy_good decode", dec),
             ("shec contrib", contrib_op), ("shec solve", s_op),
             ("liberation encode", lib.operand(lib.coding_bits)),
             ("cauchy_good k=12 decode",
              big.operand(big.recovery_bits(list(range(4, 16)))))]
    require([tuple(op.mbits.shape) for _, op in cases[:4]]
            == [(256, 512), (512, 512), (24, 64), (24, 24)],
            "gf2 operands at the slice's shapes")
    # every jerasure bit-matrix technique's encode and decode operand
    # (w 4, 6, 7, 8) with its w: the packet batches below
    techs = [(c, c.w) for c in (
        cg, lib,
        codec_from_profile("plugin=jerasure k=5 m=3 technique=cauchy_orig "
                           "w=4", device=dev),
        codec_from_profile("plugin=jerasure k=6 m=2 technique=blaum_roth "
                           "w=6", device=dev),
        codec_from_profile("plugin=jerasure k=8 m=2 technique=liber8tion",
                           device=dev))]
    packet_cases = []
    for c, w in techs:
        for which, M in (("encode", c.coding_bits),
                         ("decode", c.recovery_bits(list(range(1, c.k + 1))))):
            name = f"{c.profile['technique']} w={w} {which}"
            packet_cases.append((name, c.operand(M), w))
    require(all(op.packet is not None for _, op, _ in packet_cases)
            and contrib_op.packet is None and s_op.packet is None,
            "every jerasure operand is a 0/1 packet matrix, shec's are not")
    checked = 0

    def run(op, fn):
        """fn() through the kernel the operand picks; that kernel's count
        (and only that one) moves by one."""
        before = (g2.xor_launches.value, g2.launches.value)
        got = fn()
        xor = op.packet is not None
        require((g2.xor_launches.value - before[0],
                 g2.launches.value - before[1]) == ((1, 0) if xor else (0, 1)),
                "gf2: the operand's structure picks the kernel")
        return got

    for name, op in cases:
        for n in (1, 3, 4099, 65536, 1000003):
            x = rand(op.K, n)
            got = run(op, lambda: g2.gf2_matmul_bytes(op, x))
            require(torch.equal(got, g2.gf2_matmul_bytes_plain(op, x)),
                    f"gf2 {name} {op.mbits.shape} n={n}")
            checked += 1
    # three jobs of unequal, non-power-of-two widths at unaligned offsets,
    # for every jerasure operand (XOR kernel) and shec's (popcount kernel)
    for name, op, w in packet_cases + [("shec contrib", contrib_op, 1),
                                       ("shec solve", s_op, 1)]:
        widths = [w * 3001, w * 517, w * 12347]
        offs = [3, 3 + widths[0] + 5, 3 + widths[0] + 5 + widths[1] + 1]
        P = offs[-1] + widths[-1] + 7
        x = rand(op.K // w, P)
        out = rand(op.R // w, P)
        want = g2.gf2_matmul_packets_plain(op, x, out.clone(), offs, widths,
                                           w)
        run(op, lambda: g2.gf2_matmul_packets(op, x, out, offs, widths, w))
        require(torch.equal(out, want), f"gf2 3-job packet batch {name}")
        checked += 1
    # the popcount kernel in every K bucket (16, 32, 64, 128) and odd row
    # counts: random -3..3 operands (never 0/1 packet matrices)
    rng = np.random.default_rng(SEED)
    for R, K in ((3, 1), (8, 16), (8, 17), (17, 33), (3, 64), (96, 65),
                 (5, 128)):
        op = g2.BitOperand(rng.integers(-3, 4, (8 * R, 8 * K),
                                        dtype=np.int8))
        for n in (3, 4099, 65536):
            x = rand(K, n)
            got = run(op, lambda: g2.gf2_matmul_bytes(op, x))
            require(torch.equal(got, g2.gf2_matmul_bytes_plain(op, x)),
                    f"gf2 popcount {8 * R}x{8 * K} n={n}")
            checked += 1
    # one full-width coalesced batch: two 512 KiB jobs side by side
    half = 512 << 10
    x = rand(8, 2 * half)
    out = torch.zeros((4, 2 * half), dtype=torch.uint8, device=dev)
    want = g2.gf2_matmul_packets_plain(enc, x, out.clone(), [0, half],
                                       [half, half], 8)
    g2.gf2_matmul_packets(enc, x, out, [0, half], [half, half], 8)
    require(torch.equal(out, want), "gf2 full-width coalesced batch")
    torch.cuda.synchronize()
    log(f"gf2: {checked + 1} kernel calls bit-equal to the plain version "
        f"({', '.join(f'{n} {list(op.mbits.shape)}' for n, op in cases)}, "
        "ragged n; 3-job packet batches of "
        f"{', '.join(n for n, _, _ in packet_cases)} on the XOR kernel and "
        "of shec's two operands on the popcount kernel; random operands "
        "on the popcount kernel at every step bucket; a full-width packet "
        "batch)")


def phase_gf256i(torch, dev, log) -> None:
    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.ec.codec import RSMatrixCodec
    from ceph_tpu_torch.ops import benchloop, gf256
    from ceph_tpu_torch.ops import gf256_planes as gp

    codec = RSMatrixCodec(8, 4, matrices.isa_cauchy(8, 4), device=dev)
    rec, _ = codec.recovery_matrix([0, 1, 2, 3, 4, 5, 8, 9])
    cases = [("cauchy 4x8", matrices.isa_cauchy(8, 4)),
             ("cauchy 2x4", matrices.isa_cauchy(4, 2)),
             ("cauchy 3x3", matrices.isa_cauchy(3, 3)),
             ("recovery 8x8", rec)]
    seed = 0xA5A5A5A5
    checked = 0

    def check(name, mat, T, tiles):
        nonlocal checked
        k = mat.shape[1]
        w3 = benchloop.gen_planes(k, T, interleaved=True, device=dev)
        want = gp.encode_planes_interleaved_plain(mat, w3, seed)
        require(torch.equal(want, gp.encode_planes_interleaved_plain(
            mat, w3, seed, mul_shift=True)), f"gf256i plain {name} T={T}: "
            "both doubling variants give the same bytes")
        for tile in tiles:
            for ms in (False, True):
                got = gp.encode_planes_interleaved(mat, w3, seed, tile=tile,
                                                   mul_shift=ms)
                require(torch.equal(got, want), f"gf256i {name} T={T} "
                        f"tile={tile} mul_shift={ms}")
                checked += 1
        return w3, want

    for name, mat in cases:
        for T in (128, 4096):
            check(name, mat, T, [t for t in (1, 8, 32, 128, 256, 512, 1024)
                                 if T % t == 0])
    mat = matrices.isa_cauchy(8, 4)
    check("cauchy 4x8", mat, 65536, (128, 512, 1024))
    # every row and column bucket edge, random matrices, both seeds and
    # both doubling variants, at an odd T (the grid's last block half
    # full) and at 16 MiB of k=8 rows; a matrix past 16 x 16 runs as row
    # blocks of 16, one counted launch each
    rng = np.random.default_rng(SEED + 8)
    edges = (1, 4, 5, 8, 9, 16, 17, 32)
    for R in edges:
        for k in edges:
            em = rng.integers(0, 256, (R, k), dtype=np.uint8)
            nl = len(gf256.k1_operand(em).blocks)
            for T, tile in ((257, 1), (4096, 512)):
                w3 = benchloop.gen_planes(k, T, interleaved=True, device=dev)
                for sd in (0, seed):
                    want = gp.encode_planes_interleaved_plain(em, w3, sd)
                    for ms in (False, True):
                        before = gp.launches.value
                        got = gp.encode_planes_interleaved(
                            em, w3, sd, tile=tile, mul_shift=ms)
                        require(gp.launches.value - before == nl,
                                f"gf256i {R}x{k}: {nl} launch(es) counted")
                        require(torch.equal(got, want), f"gf256i {R}x{k} "
                                f"T={T} seed={sd:#x} mul_shift={ms}")
                        checked += 1
    # the planar planes entry (K1) and the two layouts through a transpose
    w3 = benchloop.gen_planes(8, 4096, device=dev)
    want = gp.encode_planes_plain(mat, w3, seed)
    for ms in (False, True):
        require(torch.equal(gp.encode_planes(mat, w3, seed, tile=512,
                                             mul_shift=ms), want),
                f"gf256 planes entry mul_shift={ms}")
    inter = gp.encode_planes_interleaved(
        mat, w3.transpose(0, 1).contiguous(), seed, tile=512)
    require(torch.equal(inter.transpose(0, 1), want),
            "interleaved equals planar through a transpose")
    torch.cuda.synchronize()
    log(f"gf256i: {checked} K2 calls bit-equal to the plain version "
        "((4, 8), (2, 4), (3, 3), (8, 8) recovery at T 128 and 4096, every "
        "tile, both doubling variants; k=8 at T=65536; every (R, k) bucket "
        f"edge of {list(edges)} at T 257 and 4096, both seeds and doubling "
        "variants, one counted launch per row block), the K1 planes entry "
        "and the transpose agree")


def rows_plain(torch, full, offs, lens, inits):
    """crc32c_rows by its plain definition: relay each (job, shard) row
    out of the batch, then the plain lanes CRC, on the batch's device."""
    from ceph_tpu_torch.ops.crc32c_device import crc32c_lanes_plain

    S = full.shape[0]
    width = int(max(lens))
    rows = torch.zeros((len(offs) * S, width), dtype=torch.uint8,
                       device=full.device)
    for j, (o, ln) in enumerate(zip(offs, lens)):
        rows[j * S:(j + 1) * S, :ln] = full[:, o:o + ln]
    got = crc32c_lanes_plain(rows, np.repeat(lens, S),
                             np.repeat(np.asarray(inits, np.uint32), S))
    return got.cpu().numpy().astype(np.uint32).reshape(len(offs), S)


def phase_crc(torch, dev, log) -> None:
    from ceph_tpu_torch.ops import crc32c_device as cd

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    rows = torch.randint(0, 256, (4097, 4099), dtype=torch.uint8,
                         device=dev, generator=g)
    lens = np.arange(4097)
    inits = rng.integers(0, 1 << 32, 4097, dtype=np.uint64).astype(np.uint32)
    for view, what in ((rows[:, :4096], "aligned"),
                       (rows[:, 3:], "unaligned")):
        got = cd.crc32c_lanes(view, lens, inits)
        want = cd.crc32c_lanes_plain(view, lens, inits).cpu().numpy()
        require(np.array_equal(got, want.astype(np.uint32)),
                f"crc32c lanes 0..4096 {what}")
    big = torch.randint(0, 256, (24, 512 << 10), dtype=torch.uint8,
                        device=dev, generator=g)
    blens = np.full(24, 512 << 10)
    got = cd.crc32c_lanes(big, blens)
    want = cd.crc32c_lanes_plain(big, blens).cpu().numpy()
    require(np.array_equal(got, want.astype(np.uint32)), "crc32c 512 KiB")
    whole = int(cd.crc32c_lanes(big[:1], [512 << 10])[0])
    for cut in (1, 7, 4096, 300001):
        first = int(cd.crc32c_lanes(big[:1], [cut])[0])
        rest = int(cd.crc32c_lanes(big[:1, cut:], [(512 << 10) - cut],
                                   [first])[0])
        require(rest == whole, f"crc32c chained at {cut}")
    full = torch.randint(0, 256, (12, 3 << 16), dtype=torch.uint8,
                         device=dev, generator=g)
    offs = [0, 5, (1 << 16) + 3, 2 << 16]
    jl = [5, (1 << 16) - 2, 59_999, 1 << 16]
    ji = [0, 0xFFFFFFFF, 12345, 0x80000000]
    got = cd.crc32c_rows(full, offs, jl, ji)
    require(np.array_equal(got, rows_plain(torch, full, offs, jl, ji)),
            "crc32c_rows multi-job offsets")
    # rows that end on, just before and just after the kernel's segment
    # and lane-piece boundaries, at odd column offsets
    seg, piece = cd.SEGMENT, cd.SEGMENT // 32
    edges = [0, 1, 15, 16, 17, piece - 1, piece, piece + 1, seg - 1, seg,
             seg + 1, 3 * seg + 7]
    for shift in (0, 1, 7, 13):
        offs, o = [], shift
        for ln in edges:
            offs.append(o)
            o += ln + 3
        full = torch.randint(0, 256, (12, o + 16), dtype=torch.uint8,
                             device=dev, generator=g)
        ji = rng.integers(0, 1 << 32, len(edges), dtype=np.uint64)
        got = cd.crc32c_rows(full, offs, edges, ji)
        require(np.array_equal(got, rows_plain(torch, full, offs, edges,
                                               ji)),
                f"crc32c_rows at segment and piece edges, shift {shift}")
    # the main batch's shape: 2 jobs x 12 shards x 512 KiB, at an odd
    # offset, equal to the lanes CRC of the same rows held above
    half = 512 << 10
    full = torch.zeros((12, 2 * half + 8), dtype=torch.uint8, device=dev)
    full[:, 3:3 + half] = big[:12]
    full[:, 3 + half:3 + 2 * half] = big[12:]
    got = cd.crc32c_rows(full, [3, 3 + half], [half, half])
    require(np.array_equal(got.reshape(-1), want.astype(np.uint32)),
            "crc32c_rows at the main batch shape (24 x 512 KiB)")
    torch.cuda.synchronize()
    log("crc32c: lanes 0..4096 (aligned, unaligned), 24 x 512 KiB, chained "
        f"inits, 4-job crc32c_rows, {len(edges)} rows at segment ({seg} B) "
        f"and piece ({piece} B) edges at 4 column shifts, and the 2 x 12 x "
        "512 KiB main batch bit-equal to the plain version")


def launch_counts() -> tuple:
    from ceph_tpu_torch.ops import crc32c_device as cd
    from ceph_tpu_torch.ops import crush_rule, gf2_matmul, gf256, gf256_planes
    from ceph_tpu_torch.ops import mesh_digest

    return (gf256.launches, cd.launches, gf2_matmul.launches,
            gf2_matmul.xor_launches, gf256_planes.launches,
            crush_rule.launches, mesh_digest.launches)


def reset_counts() -> None:
    for c in launch_counts():
        c.reset()


def read_counts() -> dict:
    return {c.name: c.value for c in launch_counts()}


def run_threads(fn, nobj: int, threads: int) -> float:
    """fn(i) for every object from ``threads`` threads; wall seconds."""
    errs = []

    def worker(t):
        try:
            for i in range(t, nobj, threads):
                fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ths = [threading.Thread(target=worker, args=(t,))
           for t in range(threads)]
    t0 = time.monotonic()
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    wall = time.monotonic() - t0
    if errs:
        raise errs[0]
    return wall


def drive_path(torch, dev, log, name: str, profile: str, lost,
               need_write, need_read, queue_read: bool, absent=(),
               nobj: int = 256, obj_bytes: int = 4 * MiB,
               threads: int = 8, queue=None,
               keep_shards: bool = False) -> dict:
    """Write ``nobj`` seeded objects through the stripe-batch queue's
    ``encode_crc_async`` with a 1 MiB stripe from ``threads`` threads,
    then read each back degraded with ``lost`` shards missing: through
    ``decode_data_async`` (``queue_read``) or ``codec.decode_array``.
    Every CRC and every byte is held exactly.  The launch counts are
    zeroed just before the writes and read just after them, then zeroed
    just before the reads and read just after them: each kernel in
    ``need_write`` / ``need_read`` must have run in that half, and no
    kernel in ``absent`` in either (on the card: the CPU's plain
    versions launch nothing).  ``queue`` is the queue to drive (a
    fresh ``StripeBatchQueue(device=dev)`` by default); it is stopped at
    the end either way.  The result carries every write's CRCs, each
    half's batches and mesh batches, and with ``keep_shards`` every
    object's data planes and coding."""
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue
    from ceph_tpu_torch.ops import crc32c_device as cd
    from ceph_tpu_torch.osd.ecutil import StripeInfo

    codec = codec_from_profile(profile, device=dev)
    k, m = codec.k, codec.m
    si = StripeInfo(k, codec.get_chunk_size(1 * MiB))
    require(si.chunk_size == 128 << 10, "1 MiB stripe -> 128 KiB chunks")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    objs = torch.randint(0, 256, (nobj, obj_bytes), dtype=torch.uint8,
                         device=dev, generator=g).cpu().numpy()
    planes = [si.interleave(memoryview(objs[i]))[0] for i in range(nobj)]
    width = planes[0].shape[1]
    q = StripeBatchQueue(device=dev) if queue is None else queue
    coding = [None] * nobj
    crcs = [None] * nobj
    decoded = [None] * nobj
    survivors = [s for s in range(k + m) if s not in lost]

    def write(i):
        coding[i], crcs[i] = q.encode_crc_async(
            codec, planes[i], size=obj_bytes).result()

    def read(i):
        avail = {s: planes[i][s] if s < k else coding[i][s - k]
                 for s in survivors}
        if queue_read:
            decoded[i] = q.decode_data_async(codec, avail).result()
        else:
            got = codec.decode_array(avail, list(range(k)), width)
            decoded[i] = np.stack([got[s] for s in range(k)])

    try:
        b0, mb0 = q.batches, q.mesh_batches
        reset_counts()
        w_wall = run_threads(write, nobj, threads)
        w_counts = read_counts()
        w_batches, w_jobs = q.batches - b0, q.jobs
        w_mesh = q.mesh_batches - mb0
        batch_jobs = dict(q.batch_jobs)
        reset_counts()
        r_wall = run_threads(read, nobj, threads)
        r_counts = read_counts()
        r_batches = q.batches - b0 - w_batches
        r_mesh = q.mesh_batches - mb0 - w_mesh
    finally:
        q.stop()
    on_card = torch.device(dev).type == "cuda"  # the CPU launches nothing
    for half, counts, need in (("write", w_counts, need_write),
                               ("read", r_counts, need_read)):
        require(all(counts[n] > 0 or not on_card for n in need)
                and all(counts[n] == 0 for n in absent),
                f"{name}: the {half} ran {list(need)} and none of "
                f"{list(absent)}: {counts}")
    counts = {n: w_counts[n] + r_counts[n] for n in w_counts}

    # every returned CRC against the plain CRC of the stored shard
    shards = torch.empty((nobj * (k + m), width), dtype=torch.uint8,
                         device=dev)
    for i in range(nobj):
        shards[i * (k + m):i * (k + m) + k] = torch.from_numpy(
            planes[i]).to(dev)
        shards[i * (k + m) + k:(i + 1) * (k + m)] = torch.from_numpy(
            np.ascontiguousarray(coding[i])).to(dev)
    plain = cd.crc32c_lanes_plain(
        shards, np.full(nobj * (k + m), width)).cpu().numpy()
    require(np.array_equal(np.concatenate(crcs), plain.astype(np.uint32)),
            f"{name}: every write's CRCs equal the plain CRC of its "
            "stored shards")
    for i in range(nobj):
        require(si.deinterleave(decoded[i], obj_bytes) == objs[i].tobytes(),
                f"{name}: degraded read of object {i} returns what was "
                "written")
    logical = nobj * obj_bytes
    read_via = "decode_data_async" if queue_read else "codec.decode_array"
    log(f"{name}: {profile}, wrote {nobj} x {obj_bytes >> 20} MiB from "
        f"{threads} threads in {w_wall:.3f} s = {logical / w_wall / 1e9:.3f} "
        f"GB/s encode+crc, {w_jobs} jobs in {w_batches} batches (mean "
        f"width {w_jobs / w_batches:.2f}); degraded read (lost {list(lost)}) "
        f"through {read_via} in {r_wall:.3f} s = "
        f"{logical / r_wall / 1e9:.3f} GB/s; CRCs and bytes exact; "
        f"launches: write {w_counts}, read {r_counts}")
    res = {"counts": counts, "w_counts": w_counts, "r_counts": r_counts,
           "codec": codec, "width": width, "nobj": nobj,
           "batch_jobs": batch_jobs, "survivors": survivors,
           "crcs": np.stack(crcs), "w_wall": w_wall, "r_wall": r_wall,
           "gbs": (logical / w_wall / 1e9, logical / r_wall / 1e9),
           "batches": {"write": (w_batches, w_mesh),
                       "read": (r_batches, r_mesh)}}
    if keep_shards:
        res.update(planes=planes, coding=coding)
    return res


MAIN_PROFILE = "plugin=isa k=8 m=4 technique=reed_sol_van"
MAIN_LOST = (6, 7, 10, 11)


def phase_main(torch, dev, log, nobj: int = 256,
               obj_bytes: int = 4 * MiB) -> dict:
    """``main``; its shards stay in the result for the mesh phase."""
    return drive_path(torch, dev, log, "main", MAIN_PROFILE,
                      lost=MAIN_LOST,
                      need_write=("gf256_matmul", "crc32c_rows"),
                      need_read=("gf256_matmul",), queue_read=True,
                      nobj=nobj, obj_bytes=obj_bytes, keep_shards=True)


MESH_CELLS = 8               # [dev] * 8: dp 4 x shard_par 2, test_meshio's grid
CHAIN_SURVIVORS = [0, 1, 2, 3, 4, 5, 8, 9]  # test_meshio's chain


def phase_mesh(torch, dev, log, main: dict, nobj: int = 256,
               obj_bytes: int = 4 * MiB) -> dict:
    """The ``mesh`` phase: ``main``'s workload at full width through
    ``StripeBatchQueue(device=dev, mesh=MeshCompute([dev] * 8))``, a 4 x
    2 grid of cells on the one card.  Every write and read batch must
    ride the mesh (``mesh_batches`` equal to the half's batches), K1 and
    the CRC kernel must launch in the write and K1 in the read, and every
    CRC and coding byte must equal ``main``'s.  Then the digest step folds
    each object's 12 stored shards through ``scrub_digest`` (one
    ``mesh_digest`` launch a stripe row), each digest held against
    ``mesh_digest_plain`` on the card and a one-cell mesh, and a flipped
    byte must change it; and the chained step runs
    ``encode_scatter(keep_device=True)`` into ``recovery_gather`` on card
    tensors, exact.  ``nobj`` and ``obj_bytes`` must be ``main``'s.  With
    ``dev`` the CPU (the tests) the plain versions run and launch
    nothing, so the launch checks hold on the card only."""
    from ceph_tpu_torch.gpu.meshio import MeshCompute
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue
    from ceph_tpu_torch.ops import mesh_digest as md

    mesh = MeshCompute([dev] * MESH_CELLS)
    require((mesh.dp, mesh.shard_par) == (4, 2),
            f"mesh: [dev] * 8 is a 4 x 2 grid ({mesh.dp} x "
            f"{mesh.shard_par})")
    on_card = torch.device(dev).type == "cuda"
    q = StripeBatchQueue(device=dev, mesh=mesh)
    res = drive_path(torch, dev, log, "mesh", MAIN_PROFILE, lost=MAIN_LOST,
                     need_write=("gf256_matmul", "crc32c_rows"),
                     need_read=("gf256_matmul",), queue_read=True,
                     nobj=nobj, obj_bytes=obj_bytes,
                     queue=q, keep_shards=True)
    for half, (batches, meshed) in res["batches"].items():
        require(batches > 0 and meshed == batches,
                f"mesh: every {half} batch rode the mesh ({meshed} of "
                f"{batches})")
    require(np.array_equal(res["crcs"], main["crcs"]),
            "mesh: every write's CRCs equal main's")
    nobj = res["nobj"]
    planes, coding = res.pop("planes"), res.pop("coding")
    require(all(np.array_equal(coding[i], main["coding"][i])
                for i in range(nobj)),
            "mesh: every object's coding equals main's")

    # the digest step: each object's 12 stored shards through the mesh
    stored = [np.concatenate([planes[i], coding[i]]) for i in range(nobj)]
    reset_counts()
    t0 = time.monotonic()
    digests = [mesh.scrub_digest(s) for s in stored]
    d_wall = time.monotonic() - t0
    d_counts = read_counts()
    require(d_counts["mesh_digest"] == nobj * mesh.dp * on_card
            and sum(d_counts.values()) == d_counts["mesh_digest"],
            f"mesh: one mesh_digest launch a stripe row an object and "
            f"nothing else: {d_counts}")
    solo = MeshCompute([dev])
    for i, s in enumerate(stored):
        x = torch.from_numpy(s).to(dev)
        require(digests[i] == int(md.mesh_digest_plain(x))
                == solo.scrub_digest(x),
                f"mesh: object {i}'s digest equals the plain version's "
                f"and a one-cell mesh's")
    flipped = stored[0].copy()
    flipped[3, 1000] ^= 0xFF
    require(mesh.scrub_digest(flipped) != digests[0],
            "mesh: a flipped byte changes the digest")
    fold = sum(digests) & md.MASK

    # the chained step: device tensors from the encode into the decode
    codec = res["codec"]
    reset_counts()
    x = torch.from_numpy(planes[0]).to(dev)
    coding_dev = mesh.encode_scatter(codec.coding_u8, x, keep_device=True)
    surv = torch.cat([x[:6], coding_dev[:2]])
    rec, _ = codec.recovery_matrix(CHAIN_SURVIVORS)
    rebuilt = mesh.recovery_gather(rec, surv, keep_device=True)
    c_counts = read_counts()
    require(isinstance(rebuilt, torch.Tensor) and rebuilt.device == x.device
            and torch.equal(rebuilt, x)
            and np.array_equal(coding_dev.cpu().numpy(), coding[0]),
            "mesh: encode_scatter -> recovery_gather on card tensors is "
            "exact")
    require(c_counts["gf256_matmul"] == 2 * MESH_CELLS * on_card,
            f"mesh: the chain is one K1 launch a cell a program: "
            f"{c_counts}")

    per = {half: {"batches": res["batches"][half][0],
                  "k1_per_batch": c["gf256_matmul"]
                  / res["batches"][half][0]}
           for half, c in (("write", res["w_counts"]),
                           ("read", res["r_counts"]))}
    main_per = {half: c["gf256_matmul"] / main["batches"][half][0]
                for half, c in (("write", main["w_counts"]),
                                ("read", main["r_counts"]))}
    log(f"mesh: MeshCompute([{dev}] * {MESH_CELLS}), {mesh.dp} x "
        f"{mesh.shard_par} cells, under StripeBatchQueue(mesh=): write "
        f"{res['gbs'][0]:.3f} GB/s (main {main['gbs'][0]:.3f}), degraded "
        f"read {res['gbs'][1]:.3f} GB/s (main {main['gbs'][1]:.3f}); every "
        f"batch on the mesh {json.dumps(per)} (main's K1 a batch "
        f"{json.dumps(main_per)}); CRCs and coding equal main's; digest of "
        f"{nobj} objects x 12 shards through scrub_digest in {d_wall:.3f} s "
        f"({d_counts['mesh_digest']} mesh_digest launches, fold "
        f"{fold:#010x}), each equal to the plain version's and a one-cell "
        f"mesh's, a flipped byte seen; the encode -> recovery chain on "
        f"card tensors exact ({c_counts['gf256_matmul']} K1 launches)")
    res.update(d_counts=d_counts, c_counts=c_counts, d_wall=d_wall,
               digest_shape=list(stored[0].shape))
    return res


CORE_OBJS = 32              # objects of the core phase's lockdep run
CORE_FAIL_WRITES = 8        # writes sent at the armed failpoint


def phase_core(torch, dev, log) -> dict:
    """The core host layer on the card's path, in four checks; each
    raises on failure.

    1. the host CRC-32C (``core.crc``) against the card's CRC kernel on
       the rows of a main write batch and on 1 B, 4 KiB + 3 B (at an odd
       offset) and 4 MiB buffers, and the host CRC's rate at 4 MiB;
    2. a main write and degraded read of 32 x 4 MiB (isa k=8 m=4, shards
       6, 7, 10, 11 lost) through a queue built under lockdep: bytes and
       CRCs (against the host CRC) exact, no LockOrderError;
    3. ``queue.batch.dispatch`` armed with ``error`` and ``once``: the
       jobs of exactly one batch raise FailpointError, the point is hit
       once, and the next 8 writes complete with their CRCs exact;
    4. a Context's admin socket answers ``device compile dump`` with the
       launches per kernel of checks 2 and 3 and the queue's batches.

    The launch counts are zeroed just before check 2 and read just after
    check 3."""
    import tempfile

    from ceph_tpu_torch.core import crc as hcrc
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.core import lockdep
    from ceph_tpu_torch.core.admin_socket import admin_command
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu import devwatch
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue
    from ceph_tpu_torch.ops import crc32c_device as cd
    from ceph_tpu_torch.osd.ecutil import StripeInfo

    rng = np.random.default_rng(SEED + 13)
    profile = "plugin=isa k=8 m=4 technique=reed_sol_van"
    lost = (6, 7, 10, 11)

    # 1. host CRC against the card's CRC kernel
    width = 4 * MiB // 8
    rows_checked = 0
    for w in (width, 128 << 10):  # a main batch's rows, and a chunk's
        full = torch.from_numpy(rng.integers(
            0, 256, (12, 2 * w + 8), dtype=np.uint8)).to(dev)
        offs, lens = [3, 3 + w], [w, w]
        card = cd.crc32c_rows(full, offs, lens)
        host = full.cpu().numpy()
        want = [[hcrc.crc32c(host[s, o:o + n]) for s in range(12)]
                for o, n in zip(offs, lens)]
        require(card.tolist() == want,
                f"core: crc32c_rows on the card equals the host CRC over "
                f"2 jobs x 12 shards x {w} B")
        rows_checked += 24
    big = rng.integers(0, 256, 4 * MiB + 8, dtype=np.uint8)
    bufs = {"1 B": big[:1], "4 KiB + 3 B at offset 3": big[3:3 + 4099],
            "4 MiB": big[:4 * MiB]}
    for what, buf in bufs.items():
        for init in (0, 0x9E3779B9):
            require(cd.crc32c_dev(buf, init, device=dev)
                    == hcrc.crc32c(buf, init),
                    f"core: crc32c_dev on the card equals the host CRC, "
                    f"{what}, init {init:#x}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        hcrc.crc32c(bufs["4 MiB"])
        times.append(time.perf_counter() - t0)
    host_mbs = 4 * MiB / min(times) / 1e6

    # 2. the main path under lockdep
    codec = codec_from_profile(profile, device=dev)
    k, m = codec.k, codec.m
    si = StripeInfo(k, codec.get_chunk_size(1 * MiB))
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    objs = torch.randint(0, 256, (CORE_OBJS, 4 * MiB), dtype=torch.uint8,
                         device=dev, generator=g).cpu().numpy()
    planes = [si.interleave(memoryview(o))[0] for o in objs]
    survivors = [s for s in range(k + m) if s not in lost]
    dw = devwatch.watch()
    batches0 = dw.batches
    lockdep.reset()
    lockdep.enable(True)
    try:
        q = StripeBatchQueue(device=dev)
        require(isinstance(q.pool._cond._lock, lockdep.DMutex),
                "core: the queue built under lockdep takes checked locks")
        coding = [None] * CORE_OBJS
        crcs = [None] * CORE_OBJS
        decoded = [None] * CORE_OBJS

        def write(i):
            coding[i], crcs[i] = q.encode_crc_async(
                codec, planes[i], size=4 * MiB).result()

        def read(i):
            avail = {s: planes[i][s] if s < k else coding[i][s - k]
                     for s in survivors}
            decoded[i] = q.decode_data_async(codec, avail).result()

        reset_counts()
        w_wall = run_threads(write, CORE_OBJS, 8)
        r_wall = run_threads(read, CORE_OBJS, 8)
        edges = lockdep.edge_graph()
    finally:
        lockdep.enable(False)
        lockdep.reset()
    n_edges = sum(len(v) for v in edges.values())
    require("staging.stats" in edges.get("staging.pool", {}),
            f"core: lockdep saw the staging pool's nested lock: {edges}")
    for i in range(CORE_OBJS):
        shards = list(planes[i]) + list(coding[i])
        require([int(c) for c in crcs[i]]
                == [hcrc.crc32c(sh) for sh in shards],
                f"core: object {i}'s CRCs equal the host CRC of its shards")
        require(si.deinterleave(decoded[i], 4 * MiB) == objs[i].tobytes(),
                f"core: degraded read of object {i} under lockdep")

    # 3. a failpoint on the card's path
    seen = []

    def fail(ctx):
        seen.append(ctx["jobs"])
        fp.error()(ctx)

    fp.disarm_all()
    try:
        fp.arm("queue.batch.dispatch", fail, once=True)
        outcome = [None] * CORE_FAIL_WRITES

        def armed_write(i):
            try:
                outcome[i] = q.encode_crc_async(
                    codec, planes[i % CORE_OBJS]).result()
            except fp.FailpointError as e:
                outcome[i] = e

        jobs0 = q.jobs
        run_threads(armed_write, CORE_FAIL_WRITES, CORE_FAIL_WRITES)
        failed = sum(isinstance(o, fp.FailpointError) for o in outcome)
        require(fp.hits("queue.batch.dispatch") == 1
                and fp.fired("queue.batch.dispatch") == 1,
                "core: queue.batch.dispatch hit and fired once")
        require(len(seen) == 1 and failed == seen[0]
                and q.jobs - jobs0 == CORE_FAIL_WRITES - failed,
                f"core: exactly the {seen} jobs of one batch raised "
                f"FailpointError ({failed} did)")
        for i in range(8):
            j = i % CORE_OBJS
            c, cr = q.encode_crc_async(codec, planes[j]).result()
            require(np.array_equal(c, coding[j])
                    and [int(x) for x in cr]
                    == [hcrc.crc32c(sh) for sh in
                        list(planes[j]) + list(c)],
                    f"core: write {i} after the failpoint, CRCs exact")
    finally:
        fp.disarm_all()
        q.stop()
    counts = read_counts()
    require(counts["gf256_matmul"] > 0 and counts["crc32c_rows"] > 0,
            f"core: the path ran gf256_matmul and crc32c_rows: {counts}")

    # 4. the admin socket
    with tempfile.TemporaryDirectory(prefix="chip_smoke_asok_") as tmp:
        sock = f"{tmp}/osd.0.asok"
        ctx = Context("osd.0", {"admin_socket": sock})
        try:
            dump = admin_command(sock, "device compile dump")
        finally:
            ctx.shutdown()
    require(dump["launches"] == counts,
            f"core: the dump's launches {dump['launches']} equal the "
            f"counts of checks 2 and 3 {counts}")
    require(dump["batches"]["total"] - batches0 == q.batches,
            f"core: the dump's batches ({dump['batches']['total']} - "
            f"{batches0}) equal the queue's {q.batches}")
    logical = CORE_OBJS * 4 * MiB
    log(f"core: host crc32c equals the card's on {rows_checked} batch rows "
        f"and 1 B / 4 KiB + 3 B / 4 MiB buffers; host crc32c "
        f"{host_mbs:.1f} MB/s at 4 MiB; under lockdep wrote "
        f"{CORE_OBJS} x 4 MiB in {w_wall:.3f} s = "
        f"{logical / w_wall / 1e9:.3f} GB/s and read degraded (lost "
        f"{list(lost)}) in {r_wall:.3f} s = {logical / r_wall / 1e9:.3f} "
        f"GB/s, {n_edges} lock-order edges, no LockOrderError; "
        f"queue.batch.dispatch failed {failed} of {CORE_FAIL_WRITES} jobs "
        f"(one batch), then 8 writes exact; device compile dump: "
        f"launches {dump['launches']}, {q.batches} batches")
    return {"host_crc_mbs": host_mbs, "edges": n_edges, "counts": counts}


# -- the wire phase: client ops through the PG on the wire -----------------

WIRE_PROFILE = "plugin=isa k=8 m=4 technique=reed_sol_van"  # ``main``'s
WIRE_OBJS = 32               # 4 MiB objects (RADOS's and RBD's default size),
#                              cut from 64 for the script's time limit
WIRE_PEERS = 4               # osd.1 .. osd.4 beside the primary osd.0
WIRE_DOWN = (4,)             # shut down before the degraded read
WIRE_CORRUPT = (1, 6)        # (peer, shard) whose read fails its extent seal
WIRE_SLOTS = 16              # staging slots of an object each (tpu_staging_slots)
WIRE_PGID = (2, 0)           # the PG the phase writes into
WIRE_EPOCH = 7               # its map epoch, stamped on every message and entry
WIRE_META = "_pgmeta_"       # the PG meta object that holds the log's omap
WIRE_CLIENT = 4100           # client.4100 sends the MOSDOps
WIRE_WAIT_S = 120.0
WIRE_HOLD_MS = 200           # the write's first batch held at dispatch
_DAEMON_HAS = ("is the OSD daemon's (ceph_tpu_torch/osd/daemon.py, the "
               "daemon phase); PhaseOSD hosts one PG without it")


def wire_acting(n: int, peers: int) -> list:
    """The phase's acting set: shard s on osd s % (peers + 1), so the
    primary osd.0 holds its share as a Ceph primary does."""
    return [s % (peers + 1) for s in range(n)]


class PhaseMap:
    """The phases' OSD map: the osds marked down (``is_up``)."""

    def __init__(self) -> None:
        self.down: set = set()

    def is_up(self, osd: int) -> bool:
        return osd not in self.down


class PhaseCounters:
    """The counters a PG, its backend and the recovery engine bump."""

    def __init__(self) -> None:
        self.vals: dict = {}
        self._lock = threading.Lock()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.vals[name] = self.vals.get(name, 0) + by

    def set(self, name: str, v) -> None:
        with self._lock:
            self.vals[name] = v

    def hinc(self, name: str, v) -> None:
        self.inc(name)

    def value(self, name: str, default=0):
        return self.vals.get(name, default)


class _RpcWaiter:
    def __init__(self, want: int) -> None:
        self.want = want
        self.got: list = []
        self.cond = threading.Condition()

    def add(self, msg) -> None:
        with self.cond:
            self.got.append(msg)
            self.cond.notify_all()

    def wait(self, timeout: float) -> list:
        with self.cond:
            self.cond.wait_for(lambda: len(self.got) >= self.want, timeout)
            return list(self.got)


# the daemon's scrub counters (daemon.py:240-264), osd.N.scrub
SCRUB_COUNTERS = (
    ("chunks", "deep-scrub chunks verified"),
    ("objects", "objects scrub-verified"),
    ("errors_found", "inconsistent objects found by scrub"),
    ("errors_repaired", "inconsistent objects auto-repaired"),
    ("preemptions", "chunk boundaries where client pressure preempted a "
                    "running scrub"),
    ("resumes", "deep scrubs resumed from a persisted cursor "
                "(kill/interval-change mid-scrub)"),
    ("deep_done", "completed deep scrub passes"),
    ("shallow_done", "completed shallow scrub passes"),
    ("hinfo_reseals", "partial-overwrite-invalidated hinfo crcs re-sealed "
                      "after a clean deep-scrub decode"),
)


def _pg_module(pg):
    """The module of ``pg``'s class: its package's messages (``.m``),
    types (``.t_``) and ``SCRUB_UNREADABLE``, so one host serves a PG of
    either package."""
    return sys.modules[type(pg).__module__]


class PhaseOSD:
    """The duck-typed host of a port ``PG`` (``ceph_tpu_torch/osd/pg.py``)
    over the port's messenger: the part of the daemon's routing
    (``ceph_tpu/osd/daemon.py:1169-1200,1251-1275,1489-1527,1638-1655,
    1801-1861``) that the phases drive.  ``send_to_osd`` sends on this
    osd's sessions (``conns``), dropping a message to an osd without one
    as the daemon drops one without an address; ``new_tid``;
    ``track_reads`` and ``untrack_reads``, with ``route_reply`` handing a
    sub-read reply to its callback or an RPC waiter by tid; ``rpc``; the
    scrub's ``collect_scrub_maps``, ``fetch_remote_chunk_full`` and
    ``list_peer_objects``, the ``scrub_perf`` counters, and the replica
    side of scrub and repair: ``serve_scrub`` (``MScrub``) and
    ``serve_pull`` (``MPGPull``).  Every other host method raises
    ``NotImplementedError`` pointing to the port's daemon
    (``ceph_tpu_torch/osd/daemon.py``), which has them all."""

    def __init__(self, ctx, whoami: int, store, osdmap: PhaseMap,
                 epoch: int) -> None:
        self.ctx = ctx
        self.whoami = whoami
        self.store = store
        self.osdmap = osdmap
        self._epoch = epoch
        self.conns: dict = {}
        self.addr_book: dict = {}
        self.perf = PhaseCounters()
        self.pg_perf = PhaseCounters()
        self.op_perf = None
        self.sent = PhaseCounters()  # messages sent, by type
        self.scrub_perf = ctx.perf.create(f"osd.{whoami}.scrub")
        for name, desc in SCRUB_COUNTERS:
            self.scrub_perf.add_u64_counter(name, desc)
        self.logged: list = []
        self._tid = 0
        self._tid_lock = threading.Lock()
        self._read_cbs: dict = {}
        self._waiters: dict = {}

    def epoch(self) -> int:
        return self._epoch

    def _log(self, level: int, msg: str) -> None:
        self.logged.append((level, msg))

    def connect(self, osd: int, conn, addr) -> None:
        self.conns[osd] = conn
        self.addr_book[osd] = addr

    def send_to_osd(self, osd_id: int, msg) -> None:
        conn = self.conns.get(osd_id)
        if conn is None:
            self._log(0, f"no session to osd.{osd_id}, dropping {msg!r}")
            return
        self.sent.inc(type(msg).__name__)
        conn.send(msg)

    def new_tid(self) -> int:
        with self._tid_lock:
            self._tid += 1
            return self._tid

    def track_reads(self, pgid, cb, count=None) -> int:
        tid = self.new_tid()
        if count is None:
            self._read_cbs[tid] = cb
            return tid
        remaining = [count]

        def wrapped(rep) -> None:
            remaining[0] -= 1
            if remaining[0] <= 0:
                self._read_cbs.pop(tid, None)
            cb(rep)

        self._read_cbs[tid] = wrapped
        return tid

    def untrack_reads(self, tid: int) -> None:
        self._read_cbs.pop(tid, None)

    def route_reply(self, msg) -> bool:
        """A sub-read reply to its read callback, else any reply to the
        RPC waiting on its tid (daemon.py:1266-1280)."""
        cb = self._read_cbs.get(msg.tid)
        if cb is not None:
            cb(msg)
            return True
        w = self._waiters.get(msg.tid)
        if w is not None:
            w.add(msg)
        return True

    def rpc(self, peers_msgs, timeout: float = 10.0) -> list:
        tid = self.new_tid()
        live = [(o, msg) for o, msg in peers_msgs
                if self.addr_book.get(o) is not None]
        w = self._waiters[tid] = _RpcWaiter(len(live))
        try:
            for _, msg in peers_msgs:
                msg.tid = tid
            for o, msg in live:
                self.send_to_osd(o, msg)
            return w.wait(timeout)
        finally:
            self._waiters.pop(tid, None)

    # -- scrub (daemon.py:1489-1527,1801-1861) ----------------------------
    @staticmethod
    def _missing_unreadable(pg, digests, unreadable) -> None:
        """Objects this osd knows exist but has not recovered vote
        exists-but-unservable (the daemon's missing-set rule)."""
        t_ = _pg_module(pg).t_
        with pg.lock:
            for oid in pg.missing:
                if oid not in digests and oid not in unreadable:
                    en = pg.log.latest_for(oid)
                    if en is None or en.op != t_.LOG_DELETE:
                        unreadable.append(oid)

    def serve_scrub(self, pg, msg, conn) -> None:
        """``MScrub`` -> this PG's local scrub map -> ``MScrubMap``."""
        digests, unreadable = pg.local_scrub_map(
            deep=getattr(msg, "deep", True))
        self._missing_unreadable(pg, digests, unreadable)
        rep = _pg_module(pg).m.MScrubMap(msg.pgid, self.epoch(), digests,
                                         unreadable)
        rep.tid = msg.tid
        conn.send(rep)

    def serve_pull(self, pg, msg, conn) -> None:
        """``MPGPull``: push each object to the puller, then the
        ``MPGPushReply`` that completes its RPC.  ``push_object`` waits
        on RPCs of its own, so this runs on a thread of its own, never on
        the dispatch thread that must deliver their replies (the daemon
        queues it on its workqueue)."""
        def run() -> None:
            for oid in msg.oids:
                pg.push_object(oid, msg.src.num)
            done = _pg_module(pg).m.MPGPushReply(pg.pgid, self.epoch(),
                                                 "", 0)
            done.tid = msg.tid
            conn.send(done)

        threading.Thread(target=run, daemon=True,
                         name=f"osd{self.whoami}-pull").start()

    def list_peer_objects(self, pg, osd_id: int):
        """A peer's object listing (its scrub map's key set); None when
        the peer did not answer."""
        M = _pg_module(pg).m
        reps = self.rpc([(osd_id, M.MScrub(pg.pgid, self.epoch()))])
        if reps and isinstance(reps[0], M.MScrubMap):
            return set(reps[0].digests) | set(reps[0].unreadable)
        return None

    def collect_scrub_maps(self, pg, deep: bool = True,
                           rpc_timeout=None) -> dict:
        """{osd: {oid: digest}} with store-unreadable objects merged in
        as ``SCRUB_UNREADABLE``; ``deep=False`` asks every member for the
        metadata-only map."""
        mod = _pg_module(pg)
        peers = [o for o in set(pg.acting)
                 if o not in (self.whoami, 0x7FFFFFFF) and o >= 0]
        digests, unreadable = pg.local_scrub_map(deep=deep)
        self._missing_unreadable(pg, digests, unreadable)
        digests.update({o: mod.SCRUB_UNREADABLE for o in unreadable})
        out = {self.whoami: digests}
        if peers:
            reps = self.rpc([(p, mod.m.MScrub(pg.pgid, self.epoch(),
                                              deep=deep))
                             for p in peers],
                            timeout=rpc_timeout if rpc_timeout else 10.0)
            for rep in reps:
                if isinstance(rep, mod.m.MScrubMap):
                    dm = dict(rep.digests)
                    dm.update({o: mod.SCRUB_UNREADABLE
                               for o in rep.unreadable})
                    out[rep.src.num] = dm
        return out

    def fetch_remote_chunk_full(self, pg, osd_id: int, shard: int, oid: str,
                                timeout=None):
        """(data, attrs, omap) of a remote shard, or None."""
        M = _pg_module(pg).m
        reps = self.rpc([(osd_id, M.MECSubRead(pg.pgid, self.epoch(), shard,
                                               oid, 0, 0))],
                        timeout=timeout if timeout else 10.0)
        for rep in reps:
            if isinstance(rep, M.MECSubReadReply) and rep.result == 0:
                return rep.data, dict(rep.attrs), dict(rep.omap)
        return None

    def _waits(self, name: str):
        raise NotImplementedError(f"PhaseOSD.{name} {_DAEMON_HAS}")

    def collect_pg_infos(self, *a, **kw):
        self._waits("collect_pg_infos")

    def pull_from_peer(self, *a, **kw):
        self._waits("pull_from_peer")

    def register_notify(self, *a, **kw):
        self._waits("register_notify")

    def unregister_notify(self, *a, **kw):
        self._waits("unregister_notify")


class PhaseDispatcher:
    """The messenger's ``Dispatcher`` (``ceph_tpu_torch/msg/messenger.py``)
    by duck type, so the script imports the port only once it runs: no
    fast dispatch, nothing to do on a session reset."""

    def ms_can_fast_dispatch(self, msg) -> bool:
        return False

    def ms_handle_reset(self, conn) -> None:
        pass


class PhasePeer(PhaseDispatcher):
    """osd.N: a PG behind the daemon's replica routing
    (daemon.py:1471-1488)."""

    def __init__(self, rig: "PGRig", num: int) -> None:
        from ceph_tpu_torch.store.memstore import MemStore

        self.om = rig.om
        self.store = MemStore()
        self.store.mkfs()
        self.store.mount()
        self.host = PhaseOSD(rig.ctxs[num], num, self.store, rig.osdmap,
                             WIRE_EPOCH)
        self.pg = rig.new_pg(self.host)
        self.srcs = []
        self.busy = []  # seconds serving, one entry per message

    def ms_dispatch(self, conn, msg) -> bool:
        om = self.om
        self.srcs.append(str(msg.src))
        t0 = time.perf_counter()
        if isinstance(msg, om.MECSubWriteVec):
            self.pg.handle_sub_write_vec(msg, conn)
        elif isinstance(msg, om.MECSubRead):
            self.pg.handle_sub_read(msg, conn)
        elif isinstance(msg, om.MECSubReadVec):
            self.pg.handle_sub_read_vec(msg, conn)
        elif isinstance(msg, om.MECCommitNote):
            self.pg.handle_commit_note(msg, conn)
        elif isinstance(msg, om.MScrub):
            self.host.serve_scrub(self.pg, msg, conn)
        elif isinstance(msg, om.MPGPush):
            self.pg.handle_push(msg, conn)
        elif isinstance(msg, om.MPGPull):
            self.host.serve_pull(self.pg, msg, conn)
        else:
            return False
        self.busy.append(time.perf_counter() - t0)
        return True


class PhasePrimary(PhaseDispatcher):
    """osd.0: sub-write acks to the PG's backend and sub-read replies by
    tid, inline (daemon.py:1251-1275); client ops to ``threads`` op
    threads, which call ``pg.do_op`` (the daemon's op queue).  While
    ``record`` is set it keeps every ``MECSubReadReply`` in ``reads``."""

    def __init__(self, threads: int, om) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self.om = om
        self.pg = self.host = None
        self.ops = ThreadPoolExecutor(threads, thread_name_prefix="osd0-op")
        self.failed = []   # do_op exceptions
        self.reads = []    # (oid, shard, src, result, data) replies
        self.record = True
        self.got = PhaseCounters()  # replies routed, by type

    def ms_can_fast_dispatch(self, msg) -> bool:
        return not isinstance(msg, self.om.MOSDOp)

    def do_op(self, conn, msg) -> None:
        tid = msg.tid
        is_w = any(o.is_write() for o in msg.ops)

        def reply(rep) -> None:
            rep.tid = tid
            # a reply carries each op's out data, not the write's
            # payload (a staged one would come back from the card)
            rep.ops = [dataclasses.replace(o, data=b"")
                       if o.is_write() else o for o in rep.ops]
            conn.send(rep)
            if rep.result == 0:  # the PGStat feed, as the daemon's
                self.pg.note_client_io(is_w, sum(
                    len(o.data) or o.length for o in msg.ops
                    if o.is_write()) if is_w else sum(
                    len(o.out_data) for o in rep.ops))

        try:
            self.pg.do_op(msg, reply, conn=conn)
        except Exception as e:  # noqa: BLE001 — the phase fails on it
            self.failed.append((msg.oid, repr(e)))

    def ms_dispatch(self, conn, msg) -> bool:
        om = self.om
        if isinstance(msg, om.MOSDOp):
            self.ops.submit(self.do_op, conn, msg)
            return True
        if isinstance(msg, om.MECSubWriteVecReply):
            self.pg.backend.handle_reply(msg.tid, msg.src.num)
            return True
        self.got.inc(type(msg).__name__)
        if isinstance(msg, om.MECSubReadReply) and self.record:
            self.reads.append((msg.oid, msg.shard, msg.src.num,
                               msg.result, msg.data))
        return self.host.route_reply(msg)


class PhaseClient(PhaseDispatcher):
    """client.4100: each ``MOSDOpReply`` to the op waiting on its tid."""

    def __init__(self, om, pgid, tag: str) -> None:
        self.om = om
        self.pgid = pgid
        self.tag = tag
        self.cond = threading.Condition()
        self.replies = {}

    def ms_can_fast_dispatch(self, msg) -> bool:
        return True

    def ms_dispatch(self, conn, msg) -> bool:
        if not isinstance(msg, self.om.MOSDOpReply):
            return False
        with self.cond:
            self.replies[msg.tid] = msg
            self.cond.notify_all()
        return True

    def call(self, conn, tid: int, oid: str, ops):
        msg = self.om.MOSDOp(self.pgid, WIRE_EPOCH, oid, ops)
        msg.tid = tid
        msg.reqid = f"client.{WIRE_CLIENT}.0:{tid}"
        conn.send(msg)
        with self.cond:
            require(self.cond.wait_for(lambda: tid in self.replies,
                                       WIRE_WAIT_S),
                    f"{self.tag}: a reply to {oid} (tid {tid})")
            return self.replies.pop(tid)


class PGRig:
    """One PG over messengers on 127.0.0.1, the set-up ``run_wire`` and
    ``run_clay`` share: the primary ``osd.0`` (``prim``, ``host0``,
    ``pg``) and ``peers`` peers (``osd.1`` .., ``peer_d`` and
    ``peer_m``), each a ``PG`` of ``pool`` and ``codec`` with the acting
    set ``acting`` over its own MemStore and a ``PhaseOSD`` host behind a
    messenger; cephx between the osds (a keyring, a CephxServer, the
    primary's authorizer bound to the dialed address,
    ``verify_authorizer`` with a seen-cache and the peer's own address,
    each verdict in ``verdicts``); the primary ``STATE_ACTIVE`` (set as
    ``_stub_pg`` of ``tests/test_recovery_pipeline.py`` sets it:
    ``activate()``'s peer infos and pulls are the daemon's) on a queue of
    its own for ``dev`` (``q``, in place of the process's default queue),
    its staging pool configured to ``WIRE_SLOTS`` slots of ``obj_bytes``;
    and ``client.4100``'s session to the primary (``client_d``,
    ``cconn``).  ``close`` stops what it started; a set-up that fails
    closes itself."""

    def __init__(self, dev, *, pgid, pool, codec, acting, peers: int,
                 threads: int, obj_bytes: int, tag: str) -> None:
        from ceph_tpu_torch.auth import CephxClient, CephxServer, Keyring
        from ceph_tpu_torch.core.context import Context
        from ceph_tpu_torch.gpu.queue import StripeBatchQueue
        from ceph_tpu_torch.msg.message import EntityName
        from ceph_tpu_torch.msg.messenger import Messenger
        from ceph_tpu_torch.osd import messages as om
        from ceph_tpu_torch.osd import pg as opg
        from ceph_tpu_torch.store.memstore import MemStore

        self.pgid, self.pool, self.codec = pgid, pool, codec
        self.acting = acting
        self.om = om
        self.osdmap = PhaseMap()
        self.msgrs = []
        self.prim = self.q = self.geometry = None
        self.peer_d, self.peer_m = {}, {}
        self.verdicts = {num: [] for num in range(1, peers + 1)}
        kr = Keyring()
        kr.add("service")
        secret = kr.add("osd.0")
        self.auth_server = CephxServer(kr)
        cx = CephxClient("osd.0", secret)
        ch = self.auth_server.get_challenge("osd.0")
        cc = SEED.to_bytes(16, "little")
        cx.accept_reply(*self.auth_server.handle_request(
            "osd.0", cc, cx.make_proof(ch, cc)))
        try:
            self.names = [f"osd.{num}" for num in range(peers + 1)]
            self.ctxs = [Context(name) for name in self.names]
            self.primary = Messenger(self.ctxs[0], EntityName("osd", 0))
            self.prim = PhasePrimary(threads, om)
            self.primary.add_dispatcher(self.prim)
            self.primary.set_auth(provider=cx.build_authorizer)
            self.msgrs.append(self.primary)
            for num in range(1, peers + 1):
                self.peer_d[num] = PhasePeer(self, num)
                self.start_peer(num)
            self.primary.start()
            require(all(mm.addr[0] == "127.0.0.1" for mm in self.msgrs),
                    f"{tag}: every messenger binds 127.0.0.1")
            store0 = MemStore()
            store0.mkfs()
            store0.mount()
            self.host0 = self.prim.host = PhaseOSD(
                self.ctxs[0], 0, store0, self.osdmap, WIRE_EPOCH)
            for num, pm in self.peer_m.items():
                self.host0.connect(num, self.primary.connect(pm.addr),
                                   pm.addr)
            self.pg = self.prim.pg = self.new_pg(self.host0)
            with self.pg.lock:
                self.pg.state = opg.STATE_ACTIVE
            self.q = self.pg.backend.queue = StripeBatchQueue(device=dev)
            self.geometry = (self.q.pool.slot_bytes, self.q.pool.nslots)
            require(self.q.pool.configure(obj_bytes, WIRE_SLOTS),
                    f"{tag}: the idle staging pool takes the phase's "
                    "geometry")
            self.holders = {0: store0, **{num: pd.store
                                          for num, pd in self.peer_d.items()}}
            self.pgs = {0: self.pg, **{num: pd.pg
                                       for num, pd in self.peer_d.items()}}
            self.client_d = PhaseClient(om, pgid, tag)
            client = Messenger(Context(f"client.{WIRE_CLIENT}"),
                               EntityName("client", WIRE_CLIENT))
            client.add_dispatcher(self.client_d)
            self.msgrs.append(client)
            client.start()
            self.cconn = client.connect(self.primary.addr)
        except BaseException:
            self.close()
            raise

    def new_pg(self, host: PhaseOSD):
        from ceph_tpu_torch.osd import pg as opg

        p = opg.PG(self.pgid, self.pool, host, self.codec)
        p.create_onstore()
        p.update_acting(self.acting, 0)
        return p

    def _verifier(self, num: int, target: str):
        from ceph_tpu_torch.auth import verify_authorizer

        seen = {}

        def check(blob) -> bool:
            try:
                verify_authorizer(self.auth_server.service_secret, blob,
                                  expect_target=target, seen=seen)
                ok = True
            except Exception:  # noqa: BLE001 — any refusal is a "no"
                ok = False
            self.verdicts[num].append(ok)
            return ok
        return check

    def start_peer(self, num: int):
        """Start osd.num's messenger (a restarted osd's on a context of
        its own) and return it."""
        from ceph_tpu_torch.core.context import Context
        from ceph_tpu_torch.msg.message import EntityName
        from ceph_tpu_torch.msg.messenger import Messenger

        ctx = (self.ctxs[num] if num not in self.peer_m
               else Context(f"osd.{num}"))
        pm = Messenger(ctx, EntityName("osd", num))
        pm.add_dispatcher(self.peer_d[num])
        pm.start()
        pm.set_auth(verifier=self._verifier(num,
                                            f"{pm.addr[0]}:{pm.addr[1]}"))
        self.peer_m[num] = pm
        self.msgrs.append(pm)
        return pm

    def close(self) -> None:
        if self.prim is not None:
            self.prim.ops.shutdown(wait=True)
        if self.q is not None:
            if self.geometry is not None:
                self.q.pool.configure(*self.geometry)
            self.q.stop()
        for mm in self.msgrs:
            mm.shutdown()


def run_wire(torch, dev, *, nobj: int = WIRE_OBJS,
             obj_bytes: int = 4 * MiB, stripe_bytes: int = 1 * MiB,
             peers: int = WIRE_PEERS, down=WIRE_DOWN, corrupt=WIRE_CORRUPT,
             threads: int = 8, recover: bool = True,
             scrub: bool = False) -> dict:
    """Client ops through the port's ``PG`` (``ceph_tpu_torch/osd/pg.py``)
    on the wire: the EC object write and its degraded read, then the
    primary's lost shards recovered, under lockdep:

    1. a ``PGRig`` of the primary ``osd.0`` and ``peers`` peers
       (``osd.1`` ..) over cephx, ``ms_crc_data`` on, built under
       lockdep.  The acting set puts shard s on osd ``s % (peers + 1)``.
       The primary's dispatcher (``PhasePrimary``) hands each
       ``MECSubWriteVecReply`` to its backend and each sub-read reply to
       its callback by tid, and each ``MOSDOp`` to a pool of op threads
       that call ``pg.do_op`` with a reply that sends the
       ``MOSDOpReply`` back on the session (without the write's payload:
       a reply carries out data); a peer's (``PhasePeer``) calls
       ``handle_sub_write_vec``, ``handle_sub_read``,
       ``handle_sub_read_vec`` and ``handle_commit_note``;
    2. write, from ``threads`` client threads over one session of
       ``client.4100``: one ``WRITEFULL`` ``MOSDOp`` an object;
       ``PG._do_write`` stages the payload (``DeviceBuf.stage``), mints
       its version under the PG lock and calls ``ECBackend.submit``: the
       backend interleaves it, encodes it with its CRCs in the queue's
       ``encp`` batch (K1 and the CRC kernel on the card), stamps every
       shard's ``hinfo`` with the card's CRC, applies the primary's
       shards through ``op_payload`` and sends each peer one
       ``MECSubWriteVec``, then seals the slot; the reply comes at the
       commit on every holder;
    3. check: every reply 0; every write staged, none degraded by a pool
       timeout (``stage_snapshot``); no op in flight; no unsanctioned
       host copy (``payload_host_touches`` 0); each parity handle
       fetched once (``d2h_bytes`` = ``nobj * m`` chunks); every slot
       back, at most ``WIRE_SLOTS`` used; at each ``seal()`` the
       primary's store had applied the local shards of every write so
       far through ``op_payload``; the backend took no host CRC in the
       write; every holder's ``PGLog.from_omap`` holds the ``nobj``
       entries in version order, and every PG's ``info.last_update`` and
       ``log.head`` are the last write's version; every stored shard
       passes its extent seals and its host CRC, its ``hinfo`` CRC and
       the card's CRC of it are one; the ``devbuf`` check (object 0's
       parity by K1 on a tensor of ``dev``, wrapped as that tensor, reads
       back as the queue's parity with one counted fetch); a messenger
       without an authorizer dials peer 1, is refused twice, and its
       sub-write is never delivered;
    4. degraded read: the peers in ``down`` shut down and are marked
       down, ``pg.note_peers_down(down)``, the primary goes
       ``STATE_DEGRADED`` and its object-context cache is emptied (so no
       read is served warm); ``store.corrupt_chunk`` is armed for
       ``corrupt`` = (peer, shard), whose read fails its seal and answers
       ``ECRC`` without data; one ``READ`` ``MOSDOp`` an object goes
       ``do_op`` -> ``_ec_read_object``: ``ChunkGather`` reads the local
       shards and sends one ``MECSubRead`` a remote shard, and
       ``reconstruct_async`` decodes the survivors (K1 on the card
       through the queue's ``dec`` kind, one job an object); the rotten
       shard reaches ``_note_read_verify_fail`` (``scrub_errors`` one an
       object);
    5. with ``recover``: the peers in ``down`` come back up on new
       messengers; the primary loses its local shards of every object in
       one store transaction and marks them in ``pg.missing`` at their
       log versions; ``pg.recovery_engine().recover`` rebuilds them (one
       ``MECSubReadVec`` per peer per round, the rotten shard answering
       ``ECRC``, the reconstructs through the queue's ``dec`` kind);
       every recovered shard and its ``hinfo`` must equal what stood
       before the loss, and ``missing`` and ``unfound`` end empty;
    6. with ``scrub`` (after ``recover``): ``_scrub_primary``, the
       ``scrub`` phase's code, on the same PGs with the rotten shard still
       armed: cls calls through ``do_op``, a shallow and a deep scrub, then
       five marked shards auto-repaired (``res["scrub"]``).

    The launch counts are zeroed just before the writes and read just
    after them, and likewise around the reads, around the recovery and
    around each scrub step.
    Returns the counts, walls, what was written and read, every holder's
    PG meta omap and the counters; raises on any failed check."""
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.core import lockdep
    from ceph_tpu_torch.core.crc import crc32c
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.staging import DeviceBuf
    from ceph_tpu_torch.msg.message import EntityName
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.ops import gf256
    from ceph_tpu_torch.osd import backend as ob
    from ceph_tpu_torch.osd import messages as om
    from ceph_tpu_torch.osd import pg as opg
    from ceph_tpu_torch.osd.ecutil import StripeInfo
    from ceph_tpu_torch.osd.osdmap import POOL_ERASURE, PGPool
    from ceph_tpu_torch.osd.pglog import PGLog
    from ceph_tpu_torch.osd.types import (OP_READ, OP_WRITEFULL, EVersion,
                                          OSDOp)
    from ceph_tpu_torch.store import objectstore as os_mod
    from ceph_tpu_torch.store.objectstore import GHObject, Transaction

    unit = codec_from_profile(WIRE_PROFILE, device=dev).get_chunk_size(
        stripe_bytes)
    profile = f"{WIRE_PROFILE} stripe_unit={unit}"
    codec = codec_from_profile(profile, device=dev)
    k, m = codec.k, codec.m
    n = k + m
    si = StripeInfo(k, unit)
    acting = wire_acting(n, peers)
    shards_of = {o: [s for s in range(n) if acting[s] == o]
                 for o in range(peers + 1)}
    c_peer, c_shard = corrupt
    require(recover or not scrub, "wire: the scrub runs after the recovery")
    require(c_peer != 0 and acting[c_shard] == c_peer
            and c_peer not in down
            and not any(str(c_shard) in str(s) for s in range(n)
                        if s != c_shard),
            f"wire: peer {c_peer} holds shard {c_shard} and stays up, and "
            "the failpoint's shard match selects that shard alone")
    lost = sorted([s for s in range(n) if acting[s] in down] + [c_shard])
    survivors = [s for s in range(n) if s not in lost]
    require(len(lost) <= m, f"wire: {lost} lost, at most m = {m}")
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    objs = torch.randint(0, 256, (nobj, obj_bytes), dtype=torch.uint8,
                         device=dev, generator=g).cpu().numpy()
    oids = [f"rbd_data.{i:016x}" for i in range(nobj)]
    # the stripe-0 bytes of each object's planes: the key under which
    # its encp batch's coding and CRCs are noted
    key_of = {b"".join(objs[i][r * unit:r * unit + 16].tobytes()
                       for r in range(k)): i for i in range(nobj)}
    pool = PGPool(pool_id=WIRE_PGID[0], pool_type=POOL_ERASURE, size=n,
                  erasure_code_profile=profile)
    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    fp.disarm_all()
    rig = None
    plain_op_payload = os_mod.op_payload
    plain_be_crc = ob.crc32c
    try:
        rig = PGRig(dev, pgid=WIRE_PGID, pool=pool, codec=codec,
                    acting=acting, peers=peers, threads=threads,
                    obj_bytes=obj_bytes, tag="wire")
        prim, peer_d, peer_m = rig.prim, rig.peer_d, rig.peer_m
        host0, pg, q = rig.host0, rig.pg, rig.q
        be = pg.backend
        holders, pgs = rig.holders, rig.pgs
        cid = pg.coll
        meta = GHObject(WIRE_META)
        client_d, cconn = rig.client_d, rig.cconn
        # what the card computed for each object, noted off each encp
        # future before the backend's fan-out runs
        card = {}
        card_lock = threading.Lock()
        plain_encode_crc = q.encode_crc_async

        def encode_crc_async(codec_, planes, size=0, trop=None):
            fut = plain_encode_crc(codec_, planes, size=size, trop=trop)
            i = key_of[planes[:, :16].tobytes()]

            def note(f) -> None:
                if f.exception() is None:
                    c, cr = f.result()
                    with card_lock:
                        card[i] = (c, [int(x) for x in cr])
            fut.add_done_callback(note)
            return fut

        q.encode_crc_async = encode_crc_async
        # DeviceBuf payloads applied through op_payload (the primary's
        # local shards: the peers receive bytes), read at each seal()
        applied = [0]
        seals = []

        def op_payload(op, copy=False):
            if hasattr(op.data, "wire_view"):
                applied[0] += 1
            return plain_op_payload(op, copy)

        host_crcs = [0]  # the backend's host CRC calls in the write

        def be_crc(data, crc=0):
            host_crcs[0] += 1
            return plain_be_crc(data, crc)

        versions = {}

        def write(i):
            rep = client_d.call(cconn, i + 1, oids[i], [
                OSDOp(OP_WRITEFULL, data=memoryview(objs[i]))])
            require(rep.result == 0,
                    f"wire: the write of object {i} answered {rep.result}")
            versions[i] = rep.version

        stats0 = q.stats.snapshot()
        jobs0 = q.jobs
        os_mod.op_payload = op_payload
        ob.crc32c = be_crc
        fp.arm("staging.seal", lambda ctx: seals.append(applied[0]))
        # the first batch waits at dispatch so the writes in flight
        # behind it queue up: whether an encp batch carries more than
        # one write then shows whether the PG path submits concurrently,
        # not how the payloads' host CRCs happened to spread the
        # arrivals (left alone they coalesce by chance, 0-2 batches of
        # 32-64)
        fp.arm("queue.batch.dispatch", fp.sleep_ms(WIRE_HOLD_MS),
               once=True)
        try:
            reset_counts()
            w_wall = run_threads(write, nobj, threads)
            w_counts = read_counts()
            # a reply can come at the commit before the fan-out's tail
            # seals the slot and releases the object's admission FIFO,
            # and the queue counts a batch after its results are out
            deadline = time.monotonic() + WIRE_WAIT_S
            while ((pg._oid_pipes or len(seals) < nobj
                    or q.jobs - jobs0 < nobj)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        finally:
            fp.disarm("staging.seal")
            fp.disarm("queue.batch.dispatch")
            ob.crc32c = plain_be_crc
            os_mod.op_payload = plain_op_payload
            del q.encode_crc_async
        stats1 = q.stats.snapshot()
        batch_jobs = dict(q.batch_jobs)
        occupancy = q.pool.occupancy
        w_store_s = sum(sum(pd.busy) for pd in peer_d.values())
        staged = pg.stage_snapshot()
        require(not prim.failed, f"wire: do_op raised {prim.failed}")
        require(staged == {"staged": nobj, "degraded": 0},
                f"wire: every write staged as a DeviceBuf, none degraded "
                f"by a pool timeout: {staged}")
        require(not be.in_flight and not pg._oid_pipes,
                f"wire: no write left in flight ({len(be.in_flight)}) or "
                f"admitted ({len(pg._oid_pipes)})")
        require(sorted(card) == list(range(nobj)),
                f"wire: the card coded every object ({len(card)})")
        coding = [card[i][0] for i in range(nobj)]
        crcs = [card[i][1] for i in range(nobj)]
        width = coding[0].shape[1]
        local = len(shards_of[0])
        devpath = {key: stats1[key] - stats0[key] for key in
                   ("h2d_bytes", "d2h_bytes", "payload_host_touches",
                    "staged_batches")}
        devpath["pool_occupancy_hw"] = stats1["pool_occupancy_hw"]
        devpath["occupancy_after"] = occupancy
        devpath["seals"] = len(seals)
        devpath["local_applied"] = applied[0]
        devpath["write_host_crcs"] = host_crcs[0]
        require(devpath["payload_host_touches"] == 0,
                f"wire: the write made no unsanctioned host copy {devpath}")
        require(devpath["d2h_bytes"] == nobj * m * width,
                f"wire: each parity handle fetched once, at its local "
                f"apply or its transaction's encode: {devpath['d2h_bytes']} "
                f"== {nobj} x {m} x {width}")
        require(occupancy == 0
                and 0 < devpath["pool_occupancy_hw"] <= WIRE_SLOTS,
                f"wire: every staging slot sealed back, at most "
                f"{WIRE_SLOTS} in use: {devpath}")
        require(seals == [local * (j + 1) for j in range(nobj)],
                f"wire: at each seal() the primary had applied its {local} "
                f"shards of every write so far through op_payload: {seals}")
        require(host_crcs[0] == 0,
                f"wire: the backend took the host CRC {host_crcs[0]} times "
                "in the write (hinfo takes the card's)")

        # 3. every holder's log, then every stored shard against the
        # card's CRC through the seals (one thread: two host CRC passes)
        pg_omaps = {num: st.omap_get(cid, meta)
                    for num, st in holders.items()}
        by_version = sorted((v, oids[i]) for i, v in versions.items())
        last_v = EVersion(WIRE_EPOCH, nobj)
        require([v for v, _ in by_version]
                == [EVersion(WIRE_EPOCH, j + 1) for j in range(nobj)],
                "wire: the PG minted versions 1 .. nobj")
        for num, omap in pg_omaps.items():
            log = PGLog.from_omap(omap)
            require([(en.version, en.oid) for en in log.entries]
                    == by_version,
                    f"wire: osd.{num}'s PG log holds the {nobj} entries in "
                    f"order ({len(log)} entries)")
        # a peer acks from its store's commit, a moment before its
        # handler notes the entries in its in-memory log and info
        deadline = time.monotonic() + WIRE_WAIT_S
        while True:
            heads = {num: (p.info.last_update, p.log.head)
                     for num, p in pgs.items()}
            if (all(h == (last_v, last_v) for h in heads.values())
                    or time.monotonic() > deadline):
                break
            time.sleep(0.001)
        require(all(h == (last_v, last_v) for h in heads.values()),
                f"wire: every PG's last_update and log head are the last "
                f"write's version {last_v}: {heads}")
        t_check = time.perf_counter()
        verified = 0
        hinfos = {num: {} for num in holders}
        for num, st in holders.items():
            for i in range(nobj):
                for s in shards_of[num]:
                    o = GHObject(oids[i], shard=s)
                    got = st.read(cid, o)
                    blob = hinfos[num][(i, s)] = st.getattr(cid, o, "hinfo")
                    size, hcrc, valid = ob.hinfo_decode(blob)
                    require(valid and size == obj_bytes
                            and crc32c(got) == crcs[i][s] == hcrc,
                            f"wire: osd.{num} object {i} shard {s}: host "
                            "CRC of the stored bytes and its hinfo CRC "
                            "equal the card's CRC")
                    verified += 1
        check_s = time.perf_counter() - t_check

        # the device branch of DeviceBuf: object 0's parity by K1 on a
        # tensor of ``dev``, wrapped as that tensor
        planes0 = si.interleave(objs[0])[0]
        k1_before = gf256.launches.value
        par = codec.encode_planes(torch.from_numpy(planes0).to(dev))
        d2h0 = q.stats.snapshot()["d2h_bytes"]
        view = DeviceBuf.wrap_device(par, q.stats).wire_view()
        devbuf = {"on": str(par.device), "bytes": par.numel(),
                  "d2h_grew": q.stats.snapshot()["d2h_bytes"] - d2h0,
                  "k1_launches": gf256.launches.value - k1_before}
        require(bytes(view) == coding[0].tobytes()
                and devbuf["d2h_grew"] == m * width
                and devbuf["k1_launches"] == int(dev.type == "cuda"),
                f"wire: devbuf: a parity tensor on {par.device} reads back "
                f"as the queue's parity with one fetch of its size {devbuf}")

        intruder = Messenger(None, EntityName("client", 666))
        rig.msgrs.append(intruder)
        intruder.start()
        t = Transaction()
        t.write(cid, GHObject("intruder", shard=0), 0, b"x" * 64)
        intruder.send_message(
            om.MECSubWriteVec(WIRE_PGID, WIRE_EPOCH, "intruder",
                              t.to_bytes()), peer_m[1].addr)
        deadline = time.monotonic() + 30
        while (rig.verdicts[1].count(False) < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        intruder.shutdown()
        require(rig.verdicts[1].count(False) >= 2
                and "client.666" not in peer_d[1].srcs
                and not peer_d[1].store.exists(
                    cid, GHObject("intruder", shard=0)),
                f"wire: the unauthenticated messenger was refused "
                f"{rig.verdicts[1].count(False)} times and never delivered")
        require(all(v and all(v) for num, v in rig.verdicts.items()
                    if num != 1) and rig.verdicts[1].count(True) >= 1,
                f"wire: the primary's sessions were authorized: "
                f"{rig.verdicts}")

        # 4. the degraded read through do_op, every object gathered
        for num in down:
            peer_m[num].shutdown()
            rig.osdmap.down.add(num)
        pg.note_peers_down(set(down))
        with pg.lock:
            pg.state = opg.STATE_DEGRADED
        pg._obc_invalidate()
        fp.arm("store.corrupt_chunk", fp.CORRUPT_ACTION,
               match={"shard": str(c_shard)})
        fails0 = peer_d[c_peer].store.perf.value("read_verify_fail")
        dec0 = sum(w * c for w, c in q.dec_batch_jobs.items())
        decoded = [None] * nobj

        def read(i):
            rep = client_d.call(cconn, nobj + i + 1, oids[i],
                                [OSDOp(OP_READ)])
            require(rep.result == 0,
                    f"wire: the read of object {i} answered {rep.result}")
            decoded[i] = bytes(rep.ops[0].out_data)

        reset_counts()
        r_wall = run_threads(read, nobj, threads)
        r_counts = read_counts()
        # a read answers once k chunks are in: wait (bounded) for the
        # slower sub-read replies, the rotten shard's among them, and
        # for the queue's count of the last decode batch
        asked = nobj * sum(1 for s in range(n)
                           if acting[s] != 0 and acting[s] not in down)
        deadline = time.monotonic() + WIRE_WAIT_S
        while ((len(prim.reads) < asked or pg.scrub_errors < nobj
                or sum(w * c for w, c in q.dec_batch_jobs.items()) - dec0
                < nobj) and time.monotonic() < deadline):
            time.sleep(0.001)
        r_store_s = sum(sum(pd.busy) for pd in peer_d.values()) - w_store_s
        seal_fails = (peer_d[c_peer].store.perf.value("read_verify_fail")
                      - fails0)
        dec_jobs = sum(w * c for w, c in q.dec_batch_jobs.items()) - dec0
        scrub_errors = pg.scrub_errors
        reads = list(prim.reads)
        # a deep pass gathers every shard: the sub-read replies of the
        # steps after the read are not kept
        prim.record = False
        prim.reads = []
        require(not prim.failed, f"wire: do_op raised {prim.failed}")

        perf = {name: c.perf.dump()[f"msgr.{name}"]
                for name, c in zip(rig.names, rig.ctxs)}

        # 5. the primary's shards lost and recovered over the PG
        rec = None
        if recover:
            rec = _recover_primary(pg, rig.start_peer, host0, rig.primary,
                                   rig.osdmap, q, down, oids, shards_of[0],
                                   c_shard, peers)
        scr = None
        if scrub:
            scr = _scrub_primary(pg, host0, prim, holders, client_d, cconn,
                                 q, oids, objs, corrupt, acting)
        fp.disarm_all()
        edges = lockdep.edge_graph()
    finally:
        fp.disarm_all()
        ob.crc32c = plain_be_crc
        os_mod.op_payload = plain_op_payload
        if rig is not None:
            rig.close()
        lockdep.enable(was)
        lockdep.reset()
    require(seal_fails == nobj,
            f"wire: osd.{c_peer} counted {seal_fails} read_verify_fail, one "
            f"per object ({nobj})")
    require(scrub_errors == nobj,
            f"wire: the rotten shard reached _note_read_verify_fail once an "
            f"object: scrub_errors {scrub_errors} == {nobj}")
    require(dec_jobs == nobj,
            f"wire: every read decoded on the queue's dec kind, none served "
            f"warm: {dec_jobs} jobs for {nobj} objects")
    got_shards = {i: {} for i in range(nobj)}
    failed = {i: [] for i in range(nobj)}
    index = {oid: i for i, oid in enumerate(oids)}
    for oid, shard, src, result, data in reads:
        i = index[oid]
        if result:
            failed[i].append((shard, src, result, len(data)))
        else:
            got_shards[i][shard] = data
    for i in range(nobj):
        require(failed[i] == [(c_shard, c_peer, ob.ECRC, 0)],
                f"wire: object {i}: only shard {c_shard} failed its seal, "
                f"as ECRC without data ({failed[i]})")
        require(sorted(got_shards[i]) == [s for s in survivors
                                          if acting[s] != 0],
                f"wire: object {i} read from its remote survivors")
        for s, b in got_shards[i].items():
            require(crc32c(b) == crcs[i][s],
                    f"wire: object {i} shard {s} came back as written")
            verified += 1
        require(decoded[i] == objs[i].tobytes(),
                f"wire: degraded read of object {i} returns what was written")
    remote = n - len(shards_of[0])
    wire_bytes = [nobj * remote * width,
                  sum(len(b) for i in range(nobj)
                      for b in got_shards[i].values())]
    frames = sum(int(p["frames_per_drain"]["sum"]) for p in perf.values())
    msgr_acks = sum(p["acks_dedicated"] + p["acks_piggybacked"]
                    for p in perf.values())
    logical = nobj * obj_bytes
    return {"w_counts": w_counts, "r_counts": r_counts,
            "w_gbs": logical / w_wall / 1e9, "r_gbs": logical / r_wall / 1e9,
            "w_wall": w_wall, "r_wall": r_wall, "lost": lost,
            "w_store_s": w_store_s, "r_store_s": r_store_s,
            "check_s": check_s, "acting": acting,
            "survivors": survivors, "coding": coding, "crcs": crcs,
            "decoded": decoded, "objs": objs, "si": si,
            "wire_bytes": wire_bytes, "frames": frames,
            "msgr_acks": msgr_acks, "sub_acks": nobj * peers,
            "verified": verified, "seal_fails": seal_fails,
            "batch_jobs": batch_jobs, "devpath": devpath, "devbuf": devbuf,
            "pg_omaps": pg_omaps, "hinfos": hinfos, "staged": staged,
            "scrub_errors": scrub_errors, "dec_jobs": dec_jobs,
            "heads": {num: str(h[0]) for num, h in heads.items()},
            "edges": sum(len(v) for v in edges.values()), "edge_graph": edges,
            "refused": rig.verdicts[1].count(False), "recovery": rec,
            "scrub": scr}


def _recover_primary(pg, start_peer, host0, primary, osdmap, q, down, oids,
                     local, c_shard, peers) -> dict:
    """The ``recovery`` phase's code, on ``run_wire``'s PGs after its read:
    the osds in ``down`` come back, the primary loses its ``local``
    shards of every object in one transaction (marked in ``pg.missing``
    at their log versions), and ``pg.recovery_engine().recover``
    rebuilds them; returns its wall, rounds, messages and launches."""
    from ceph_tpu_torch.osd.backend import hinfo_decode
    from ceph_tpu_torch.store.objectstore import GHObject, Transaction

    for num in down:
        pm = start_peer(num)
        host0.connect(num, primary.connect(pm.addr), pm.addr)
        osdmap.down.discard(num)
    store, cid = host0.store, pg.coll
    before = {(oid, s): (bytes(store.read(cid, GHObject(oid, shard=s))),
                         store.getattr(cid, GHObject(oid, shard=s), "hinfo"))
              for oid in oids for s in local}
    t = Transaction()
    for oid in oids:
        for s in local:
            t.remove(cid, GHObject(oid, shard=s))
    store.queue_transaction(t)
    with pg.lock:
        for oid in oids:
            pg.missing[oid] = pg.log.latest_for(oid).version
        work = {oid: pg.log.latest_for(oid) for oid in oids}
    require(not any(store.exists(cid, GHObject(oid, shard=s))
                    for oid in oids for s in local),
            "recovery: the primary's local shards are gone")
    perf = host0.pg_perf
    msgs0 = perf.value("subread_msgs")
    dec0 = sum(w * c for w, c in q.dec_batch_jobs.items())
    window = int(host0.ctx.conf.get("osd_recovery_max_active"))
    reset_counts()
    t0 = time.monotonic()
    pg.recovery_engine().recover(work)
    wall = time.monotonic() - t0
    deadline = time.monotonic() + WIRE_WAIT_S  # the last batch's count
    while (sum(w * c for w, c in q.dec_batch_jobs.items()) - dec0
           < len(oids) and time.monotonic() < deadline):
        time.sleep(0.001)
    counts = read_counts()
    rounds = -(-len(oids) // window)
    msgs = perf.value("subread_msgs") - msgs0
    dec_jobs = sum(w * c for w, c in q.dec_batch_jobs.items()) - dec0
    with pg.lock:
        missing, unfound = dict(pg.missing), set(pg.unfound)
    require(not missing and not unfound,
            f"recovery: missing {sorted(missing)[:4]} unfound "
            f"{sorted(unfound)[:4]} after the window")
    for (oid, s), (data, hinfo) in before.items():
        g = GHObject(oid, shard=s)
        got = bytes(store.read(cid, g))
        require(got == data and store.getattr(cid, g, "hinfo") == hinfo
                and hinfo_decode(hinfo)[2],
                f"recovery: {oid} shard {s} and its hinfo as before the loss")
    require(msgs <= peers * rounds,
            f"recovery: {msgs} sub-read messages, at most {peers} peers x "
            f"{rounds} rounds")
    require(dec_jobs == len(oids),
            f"recovery: every object reconstructed on the queue's dec kind "
            f"({dec_jobs} jobs for {len(oids)} objects)")
    return {"wall": wall, "objs_per_s": len(oids) / wall, "rounds": rounds,
            "window": window, "subread_msgs": msgs, "dec_jobs": dec_jobs,
            "counts": counts, "shards": len(before),
            "bytes": sum(len(d) for d, _ in before.values()),
            "rotten_shard": c_shard,
            "pushes": host0.perf.value("recovery_pushes")}


# the scrub phase's auto-repair: (object index, shard) of each marked
# shard.  Five is osd_scrub_auto_repair_num_errors (Ceph's default): one
# of the primary's own shards (shard 0) and data and parity shards on
# three peers (shards 1 and 11 on osd.1, 7 on osd.2, 8 on osd.3)
SCRUB_MARKS = ((1, 0), (2, 1), (3, 7), (4, 8), (5, 11))
SCRUB_LOCK_OWNER = f"client.{WIRE_CLIENT}"


def _scrub_primary(pg, host0, prim, holders, client_d, cconn, q, oids, objs,
                   corrupt, acting) -> dict:
    """The ``scrub`` phase's code, on ``run_wire``'s PGs after the
    recovery, with the ``store.corrupt_chunk`` failpoint still armed on
    shard ``corrupt[1]`` of osd ``corrupt[0]``:

    1. cls through ``do_op``: ``client.4100`` sends ``OP_CALL``
       ``MOSDOp``s on the first object: ``lock.lock`` (a write: the
       object, host bytes to the method, re-encoded in an ``enc`` job),
       ``lock.get_info``, a
       second ``lock.lock`` by another owner (``EBUSY``),
       ``version.set`` and ``version.check``; each reply's result and
       out bytes are checked, then a ``READ`` of the object, byte for
       byte;
    0. the PG, degraded since the read, is active again;
    2. ``scrub_engine().run(deep=False)``: metadata only, so clean;
    3. ``run(deep=True)`` with ``osd_scrub_auto_repair`` off: every
       object names the rotten shard, ``scrub_errors`` is recounted to
       the objects' count, the stamps row is written and the cursor
       cleared, one ``dec`` job an object in batches wider than one;
    4. the failpoint disarmed, the stores' data-err marks armed on the
       ``SCRUB_MARKS`` shards, ``run(deep=True, auto_repair=True)``
       returns ``{}`` and ``scrub_errors`` 0; every repaired shard's
       bytes and ``hinfo`` equal what stood before the rot, its ``_av``
       is ``pg._av_for(oid)`` and its mark is cleared; a last
       ``run(deep=True)`` returns ``{}``.

    The launch counts are zeroed just before each step and read just
    after it.  Returns each step's wall, launches and messages, the
    deep passes' gathered bytes, the ``dec`` batch widths and the
    ``scrub_perf`` dump; raises on any failed check."""
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.osd import scrub as oscrub
    from ceph_tpu_torch.osd.backend import hinfo_decode
    from ceph_tpu_torch.osd.pg import STATE_ACTIVE
    from ceph_tpu_torch.osd.types import OP_CALL, OP_READ, OSDOp
    from ceph_tpu_torch.store.objectstore import GHObject

    c_peer, c_shard = corrupt
    with pg.lock:
        # every peer up and nothing missing after the recovery: the PG is
        # active again, as the daemon's next peering would leave it (a
        # degraded PG holds a write's ack below k members)
        require(not pg.missing and not pg.unfound,
                "scrub: the recovery left nothing missing")
        pg.state = STATE_ACTIVE
    be, cid = pg.backend, pg.coll
    n = be.k + be.m
    nobj = len(oids)
    width = len(be.read_local_chunk(oids[0], acting.index(0)))
    eng = pg.scrub_engine()
    conf = host0.ctx.conf
    require(not conf.get("osd_scrub_auto_repair")
            and int(conf.get("osd_scrub_auto_repair_num_errors"))
            == len(SCRUB_MARKS),
            "scrub: auto-repair off by default, its cap at 5 errors")
    meta = GHObject(WIRE_META)
    tids = iter(range(2 * nobj + 1, 1 << 30))
    steps = {}

    def dec_jobs() -> dict:
        return dict(q.dec_batch_jobs)

    # where a step's wall goes, on the host's clock: the remote shards'
    # RPCs, the local shard reads, each object's re-encode (an enc job
    # and its chunks' bytes) and the wait for each decode with the
    # object's assembly
    timed = ((host0, "fetch_remote_chunk_full", "remote_gather_s"),
             (be, "read_local_chunk", "local_read_s"),
             (be, "_encode_object", "encode_s"),
             (eng, "_resolve_state", "decode_wait_s"))

    def run_step(name: str, fn, want_dec: int = 0):
        sent0, got0 = dict(host0.sent.vals), dict(prim.got.vals)
        perf0 = host0.scrub_perf.dump()
        dec0 = dec_jobs()
        split = {key: 0.0 for _, _, key in timed}

        def timer(plain_fn, key):
            def call(*a, **kw):
                t = time.monotonic()
                try:
                    return plain_fn(*a, **kw)
                finally:
                    split[key] += time.monotonic() - t
            return call

        for obj, attr, key in timed:
            setattr(obj, attr, timer(getattr(obj, attr), key))
        reset_counts()
        t0 = time.monotonic()
        try:
            out = fn()
        finally:
            wall = time.monotonic() - t0
            for obj, attr, _ in timed:
                delattr(obj, attr)
        # the queue counts a batch after its results are out
        deadline = time.monotonic() + WIRE_WAIT_S
        while (sum(w * (c - dec0.get(w, 0))
                   for w, c in q.dec_batch_jobs.items()) < want_dec
               and time.monotonic() < deadline):
            time.sleep(0.001)
        counts = read_counts()
        widths = {w: c - dec0.get(w, 0) for w, c in dec_jobs().items()
                  if c - dec0.get(w, 0)}
        steps[name] = {
            "wall": wall, "split": split, "counts": counts,
            "dec_widths": widths,
            "dec_jobs": sum(w * c for w, c in widths.items()),
            "sent": {k: v - sent0.get(k, 0) for k, v in host0.sent.vals.items()
                     if v - sent0.get(k, 0)},
            "got": {k: v - got0.get(k, 0) for k, v in prim.got.vals.items()
                    if v - got0.get(k, 0)},
            "scrub_perf": {k: v - perf0[k]
                           for k, v in host0.scrub_perf.dump().items()
                           if v - perf0[k]}}
        return out

    # 1. cls through do_op
    oid0 = oids[0]
    lk = {"name": "scrub", "owner": SCRUB_LOCK_OWNER}
    jobs = {"enc": 0, "encp": 0}
    plain = {"enc": q.encode_async, "encp": q.encode_crc_async}

    def counted(kind):
        def submit(*a, **kw):
            jobs[kind] += 1
            return plain[kind](*a, **kw)
        return submit

    def call(method: str, indata: bytes):
        rep = client_d.call(cconn, next(tids), oid0,
                            [OSDOp(OP_CALL, name=method, data=indata)])
        return rep.result, rep.ops[0].rval, bytes(rep.ops[0].out_data)

    def cls_calls():
        return [call("lock.lock", json.dumps(lk).encode()),
                call("lock.get_info", json.dumps({"name": "scrub"}).encode()),
                call("lock.lock", json.dumps(
                    {"name": "scrub", "owner": "client.4101"}).encode()),
                call("version.set", b"19"),
                call("version.check", b"19")]

    q.encode_async, q.encode_crc_async = counted("enc"), counted("encp")
    try:
        got = run_step("cls", cls_calls)
    finally:
        del q.encode_async, q.encode_crc_async
    info = json.dumps({"type": "exclusive", "owners": [SCRUB_LOCK_OWNER]})
    want = [(0, 0, b""), (0, 0, info.encode()), (-16, -16, b""),
            (0, 0, b""), (0, 0, b"")]
    require(got == want, f"scrub: the cls replies {got} == {want}")
    # a cls method sees the object as host bytes (the reference's
    # pull-back in _exec_call), so its rewrite rides the queue's enc kind
    # (K1) and each shard's hinfo takes the host CRC
    steps["cls"]["jobs"] = dict(jobs)
    require(jobs == {"enc": 2, "encp": 0}
            and steps["cls"]["sent"].get("MECSubWriteVec", 0)
            == 2 * len(set(acting) - {0}),
            f"scrub: the two cls writes re-encoded the object in one enc "
            f"job each ({jobs}) and sent each peer one MECSubWriteVec "
            f"({steps['cls']['sent']})")
    pg._obc_invalidate()
    rep = client_d.call(cconn, next(tids), oid0, [OSDOp(OP_READ)])
    require(rep.result == 0 and bytes(rep.ops[0].out_data)
            == objs[0].tobytes(),
            "scrub: a READ after the cls writes returns the object exactly")

    # 2. shallow: metadata only, the rotten data is invisible to it
    errs = run_step("shallow", lambda: eng.run(deep=False))
    require(errs == {}, f"scrub: the shallow scrub is clean: "
                        f"{sorted(errs)[:4]}")
    require(steps["shallow"]["sent"].get("MScrub", 0) == len(holders) - 1
            and steps["shallow"]["got"].get("MScrubMap", 0)
            == len(holders) - 1,
            f"scrub: one MScrub and MScrubMap a peer {steps['shallow']}")

    # 3. deep, finding
    errs = run_step("deep", lambda: eng.run(deep=True), want_dec=nobj)
    bad = [f"shard {c_shard} (osd.{c_peer}): missing or crc mismatch"]
    require(sorted(errs) == sorted(oids)
            and all(e == bad for e in errs.values()),
            f"scrub: every object names {bad}: {len(errs)} objects, "
            f"{sorted({tuple(e) for e in errs.values()})}")
    om = host0.store.omap_get(cid, meta)
    require(pg.scrub_errors == nobj
            and oscrub.decode_stamps(om[oscrub.STAMPS_KEY])
            == (pg.last_scrub, pg.last_deep_scrub, nobj)
            and eng._load_cursor() == (False, "") and eng.cursor == "",
            f"scrub: scrub_errors {pg.scrub_errors} recounted to {nobj}, "
            f"the stamps row written, the cursor cleared")
    d = steps["deep"]
    require(d["dec_jobs"] == nobj and max(d["dec_widths"]) > 1,
            f"scrub: one dec job an object in batches wider than one "
            f"{d['dec_widths']}")
    require(d["sent"].get("MECSubRead", 0) == nobj * (n - len(
        [s for s in range(n) if acting[s] == 0])),
            f"scrub: one MECSubRead a remote shard {d['sent']}")

    # 4. repair: the failpoint off, five shards marked
    fp.disarm("store.corrupt_chunk")
    marked = [(oids[i % nobj], s) for i, s in SCRUB_MARKS]
    before = {}
    for oid, s in marked:
        st, g = holders[acting[s]], GHObject(oid, shard=s)
        before[(oid, s)] = (bytes(st.read(cid, g)), st.getattr(cid, g, "hinfo"))
    for oid, s in marked:
        st = holders[acting[s]]
        st.debug_data_err_enabled = True
        st.debug_inject_data_err(cid, GHObject(oid, shard=s))
    try:
        # a deep pass, the repairs (the codec's own decode), and the
        # repaired objects verified again
        errs = run_step("repair", lambda: eng.run(deep=True, auto_repair=True),
                        want_dec=nobj + len(marked))
        require(errs == {} and pg.scrub_errors == 0,
                f"scrub: auto-repair left {errs}, scrub_errors "
                f"{pg.scrub_errors}")
        for (oid, s), (data, hinfo) in before.items():
            st, g = holders[acting[s]], GHObject(oid, shard=s)
            require((cid.name, oid, s) not in getattr(st, "_data_err_objs",
                                                      set())
                    and bytes(st.read(cid, g)) == data
                    and st.getattr(cid, g, "hinfo") == hinfo
                    and hinfo_decode(hinfo)[2]
                    and st.getattr(cid, g, "_av") == pg._av_for(oid),
                    f"scrub: {oid} shard {s} on osd.{acting[s]} repaired: "
                    f"its bytes, hinfo and _av, its mark cleared")
        r = steps["repair"]
        remote = sum(acting[s] != 0 for _, s in marked)
        require(r["scrub_perf"].get("errors_repaired") == len(marked)
                and r["sent"].get("MPGPush", 0) == remote
                and r["got"].get("MPGPushReply", 0) == remote,
                f"scrub: {len(marked)} objects repaired, one MPGPush a "
                f"peer's shard ({remote}): {r}")
        errs = run_step("final", lambda: eng.run(deep=True), want_dec=nobj)
        require(errs == {} and pg.scrub_errors == 0,
                f"scrub: the last deep scrub is clean: {errs}")
    finally:
        for st in holders.values():
            st.debug_data_err_enabled = False
    for name in ("deep", "repair", "final"):
        steps[name]["gathered_bytes"] = nobj * n * width
        steps[name]["gbs"] = nobj * n * width / steps[name]["wall"] / 1e9
        steps[name]["objs_per_s"] = nobj / steps[name]["wall"]
    om = host0.store.omap_get(cid, meta)
    return {"steps": steps, "width": width, "marked": marked,
            "scrub_perf": host0.scrub_perf.dump(),
            "stamps": om[oscrub.STAMPS_KEY], "cursor": om[oscrub.CURSOR_KEY]}


def phase_wire(torch, dev, log) -> dict:
    """``run_wire`` at full width: isa k=8 m=4 (the ``main`` profile), a
    1 MiB stripe, 32 x 4 MiB objects written and read by ``MOSDOp``
    through ``PG.do_op``, the primary and four peers; osd.4 (shards 4,
    9) down and shard 6 rotten on osd.1 for the degraded read.  The
    write half must launch K1 and the CRC kernel, the read half K1, and
    at least one encp batch must carry more than one write (the write's
    first batch waits ``WIRE_HOLD_MS`` at ``queue.batch.dispatch``, so
    the writes in flight queue up behind it)."""
    res = run_wire(torch, dev, scrub=True)
    require(res["lost"] == [4, 6, 9], f"wire: lost {res['lost']}")
    for half, counts, need in (("write", res["w_counts"],
                                ("gf256_matmul", "crc32c_rows")),
                               ("read", res["r_counts"], ("gf256_matmul",))):
        require(all(counts[n] > 0 for n in need),
                f"wire: the {half} ran {list(need)}: {counts}")
    require(max(res["batch_jobs"]) > 1,
            f"wire: an encp batch carried more than one write: "
            f"{res['batch_jobs']}")
    wb = res["wire_bytes"]
    checks = {"devpath": res["devpath"], "devbuf": res["devbuf"],
              "encp_batch_jobs": res["batch_jobs"], "staged": res["staged"],
              "scrub_errors": res["scrub_errors"],
              "dec_jobs": res["dec_jobs"], "heads": res["heads"],
              "pg_log_entries": {n: sum(k[0].isdigit() for k in o)
                                 for n, o in res["pg_omaps"].items()},
              "rollback_rows": {n: sum(k.startswith("rb_") for k in o)
                                for n, o in res["pg_omaps"].items()}}
    log(f"wire: isa k=8 m=4, 1 MiB stripe, {WIRE_OBJS} x 4 MiB by "
        f"WRITEFULL MOSDOp from client.{WIRE_CLIENT} through PG.do_op "
        f"(staged as a DeviceBuf in {WIRE_SLOTS} slots, ECBackend.submit: "
        f"the queue's encp batch, the hinfo from the card's CRC, the "
        f"primary's shards into its store through op_payload, one "
        f"MECSubWriteVec a peer) over the messenger (cephx, ms_crc_data) "
        f"to {WIRE_PEERS} peer PGs: write {res['w_gbs']:.3f} GB/s "
        f"({res['w_wall']:.3f} s), degraded READ MOSDOp through "
        f"_ec_read_object (ChunkGather, one MECSubRead a remote shard, "
        f"reconstruct_async; lost {res['lost']}: osd.4 down, shard 6 "
        f"rotten; the context cache emptied) {res['r_gbs']:.3f} GB/s "
        f"({res['r_wall']:.3f} s); peers' serving time summed "
        f"{res['w_store_s']:.3f} s in the write, {res['r_store_s']:.3f} s "
        f"in the read; the one-thread check of every stored shard (two "
        f"host CRC passes) {res['check_s']:.3f} s; shard bytes on the wire "
        f"{wb[0]} written + {wb[1]} read; {res['frames']} frames sent, "
        f"{res['sub_acks']} sub-write replies, {res['msgr_acks']} session "
        f"acks; {res['verified']} seal-verified shard reads, "
        f"{res['seal_fails']} seal failures (ECRC replies); unauthenticated "
        f"messenger refused {res['refused']} times, nothing delivered; "
        f"{res['edges']} lock-order edges {res['edge_graph']}, no "
        f"LockOrderError; launches: write {res['w_counts']}, read "
        f"{res['r_counts']}; host CRC and hinfo equal the card's CRC on "
        f"every stored shard; every reply 0 and every byte exact; checks "
        f"{json.dumps(checks)}")
    return res


def phase_recovery(torch, dev, log, wire: dict) -> dict:
    """The ``recovery`` phase: ``run_wire``'s step 5 on the wire phase's
    PGs (osd.4 back, the primary's shards 0, 5 and 10 of all 32 objects
    lost and rebuilt by ``PG.recovery_engine().recover`` from exactly
    k = 8 sources, the rotten shard 6 answering ``ECRC``).  K1 must
    launch in it."""
    rec = wire["recovery"]
    require(rec is not None, "recovery: the wire phase ran the recovery")
    require(rec["counts"]["gf256_matmul"] > 0,
            f"recovery: K1 ran in the window {rec['counts']}")
    log(f"recovery: the primary's shards 0, 5, 10 of {WIRE_OBJS} x 4 MiB "
        f"objects ({rec['shards']} shards, {rec['bytes']} bytes) lost in "
        f"one transaction and rebuilt through PG.recovery_engine() "
        f"(window {rec['window']}, {rec['rounds']} rounds, "
        f"{rec['subread_msgs']} MECSubReadVec, {rec['dec_jobs']} dec jobs, "
        f"{rec['pushes']} recovery pushes; shard {rec['rotten_shard']} "
        f"rotten, so exactly k sources): wall {rec['wall']:.3f} s, "
        f"{rec['objs_per_s']:.2f} objects/s; launches {rec['counts']}; "
        f"every shard and hinfo as before the loss; missing and unfound "
        f"empty")
    walls = {"wall_s": rec["wall"], "objs_per_s": rec["objs_per_s"],
             "rounds": rec["rounds"]}
    log(f"recovery wall: {json.dumps(walls)}")
    return rec


def phase_scrub(torch, dev, log, wire: dict) -> dict:
    """The ``scrub`` phase: ``run_wire``'s step 6 (``_scrub_primary``) on
    the wire phase's PGs, 32 x 4 MiB isa k=8 m=4 objects with shard 6
    still rotten on osd.1: cls through ``do_op``, a shallow scrub, a deep
    scrub that names shard 6 on all 32 objects, then five marked shards
    auto-repaired and a clean deep scrub.  K1 must launch in the cls
    writes and in each deep pass."""
    scr = wire["scrub"]
    require(scr is not None, "scrub: the wire phase ran the scrub")
    steps = scr["steps"]
    for name in ("cls", "deep", "repair", "final"):
        require(steps[name]["counts"]["gf256_matmul"] > 0,
                f"scrub: K1 ran in the {name} step {steps[name]['counts']}")
    walls = {name: s["wall"] for name, s in steps.items()}
    split = {name: steps[name]["split"] for name in ("deep", "repair",
                                                     "final")}
    deep = {name: {"wall_s": steps[name]["wall"],
                   "gathered_bytes": steps[name]["gathered_bytes"],
                   "gbs": steps[name]["gbs"],
                   "objs_per_s": steps[name]["objs_per_s"],
                   "dec_jobs": steps[name]["dec_jobs"],
                   "dec_widths": steps[name]["dec_widths"]}
            for name in ("deep", "repair", "final")}
    launches = {name: {k: v for k, v in s["counts"].items() if v}
                for name, s in steps.items()}
    msgs = {name: {"sent": s["sent"], "got": s["got"]}
            for name, s in steps.items()}
    log(f"scrub: on the wire phase's PGs ({WIRE_OBJS} x 4 MiB, isa k=8 "
        f"m=4, shard 6 rotten on osd.1): OP_CALL MOSDOps from "
        f"client.{WIRE_CLIENT} through do_op (lock.lock, lock.get_info, "
        f"lock.lock by another owner EBUSY, version.set, version.check; "
        f"{steps['cls']['jobs']} encode jobs; the READ after byte-exact), "
        f"scrub_engine().run: shallow clean, deep naming shard 6 on "
        f"{WIRE_OBJS} objects (scrub_errors {WIRE_OBJS}, stamps written, "
        f"cursor cleared), shards {scr['marked']} marked and auto-repaired "
        f"(bytes, hinfo and _av as before, marks cleared, scrub_errors 0), "
        f"a last deep pass clean; walls {json.dumps(walls)}, split "
        f"{json.dumps(split)}; deep passes "
        f"{json.dumps(deep)}; launches {json.dumps(launches)}; messages "
        f"{json.dumps(msgs)}; scrub_perf {json.dumps(scr['scrub_perf'])}")
    return scr


DAEMON_OSDS = 12             # one port OSDService a shard of isa k=8 m=4
DAEMON_OBJS = 32             # 4 MiB objects written to pool A, cut from
#                              64 for the script's time limit
DAEMON_EC_POOL = 2           # pool A: the wire profile, size k+m
DAEMON_REP_POOL = 1          # pool B: replicated, size 3
DAEMON_PG_NUM = 8
DAEMON_REP_OBJS = 16         # small writes to pool B
DAEMON_REP_BYTES = 64 << 10
DAEMON_OVERWRITE = (8, 4)    # pool A, pool B objects rewritten while down
DAEMON_SCRUB_IV = 0.5        # the scheduled scrub's interval (seconds)
DAEMON_RMW_OBJS = 4          # pool A objects partly overwritten
# each step's counts of the stores' commits, and of the PGs' ranged
# shard reads (by the branch the backend took) and laggard push retries
DAEMON_STORE_COUNTS = ("queued_txns", "dev_fsyncs")
DAEMON_PG_COUNTS = ("extent_reads_at_rest", "extent_reads_whole_chunk",
                    "laggard_retries")
# threads that outlive the daemons by design: the process's stripe-batch
# queue worker and the EC fan-out executor, stopped at interpreter exit
DAEMON_SHARED_THREADS = ("stripe-batch", "pg-fanout")


def daemon_map(dev, n_osds: int, profile: str, k: int, pg_num: int):
    """``build_flat_cluster(n_osds, hosts=n_osds)`` with a firstn and an
    indep rule (host failure domain), pool B replicated (size 3,
    min_size 2) on the first and pool A (the EC ``profile``, size
    ``n_osds``, min_size k + 1) on the second, ``pg_num`` PGs each."""
    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.osd.osdmap import (POOL_ERASURE, POOL_REPLICATED,
                                           OSDMap, PGPool)

    cm, root = cmap.build_flat_cluster(n_osds, hosts=n_osds)
    cm.add_simple_rule("replicated", root, 1, mode="firstn")
    cm.add_simple_rule("ec", root, 1, mode="indep")
    om = OSDMap(cm, max_osd=n_osds, device=dev)
    om.add_pool(PGPool(DAEMON_REP_POOL, POOL_REPLICATED, size=3,
                       min_size=2, pg_num=pg_num, pgp_num=pg_num,
                       crush_rule=0))
    om.add_pool(PGPool(DAEMON_EC_POOL, POOL_ERASURE, size=n_osds,
                       min_size=k + 1, pg_num=pg_num, pgp_num=pg_num,
                       crush_rule=1, erasure_code_profile=profile))
    return om


class DaemonSet:
    """Port OSD daemons on one map, booted, refreshed, killed, revived and
    stopped as ``run_daemon`` and ``run_cluster`` drive them: one
    ``OSDService`` a store of ``stores`` (``store_factory(i)``, MemStores
    without one), all on ``osdmap``, sharing ``ctx``.  ``refresh`` hands
    every live daemon the map and the address book (timed, its K6
    launches counted into ``refreshes``), then each function of
    ``watchers`` the book (a client's objecter), then activates every
    daemon and waits for its PGs to settle."""

    def __init__(self, dev, ctx, osdmap, n_osds: int, what: str,
                 store_factory=None) -> None:
        from ceph_tpu_torch.store.memstore import MemStore

        self.dev, self.ctx, self.osdmap, self.what = dev, ctx, osdmap, what
        self.make_store = store_factory or (lambda i: MemStore())
        self.stores = {i: self.make_store(i) for i in range(n_osds)}
        self.osds: dict = {}
        self.refreshes: list = []
        self.watchers: list = []

    def service(self, i: int):
        from ceph_tpu_torch.ec import codec_from_profile
        from ceph_tpu_torch.osd.daemon import OSDService

        return OSDService(self.ctx, i, self.stores[i], self.osdmap,
                          codec_from_profile, device=self.dev)

    def up(self) -> list:
        return [o for o in self.osds.values() if o.up]

    def book(self) -> dict:
        return {i: o.addr for i, o in self.osds.items() if o.up}

    def boot(self) -> None:
        """mkfs and ``init`` every daemon (its boot warmup, when the
        context asks for one, before its messengers serve)."""
        for i in sorted(self.stores):
            svc = self.service(i)
            svc.store.mkfs()
            svc.init()
            self.osds[i] = svc

    def refresh(self, name: str) -> None:
        book = self.book()
        k6 = read_counts()["crush_rule"]
        t0 = time.perf_counter()
        for o in self.up():
            o.handle_osdmap(self.osdmap, book)
        wall = time.perf_counter() - t0
        self.refreshes.append({
            "step": name, "epoch": self.osdmap.epoch, "daemons": len(book),
            "pgs": sum(len(o.pgs) for o in self.up()),
            "k6": read_counts()["crush_rule"] - k6, "wall_s": wall})
        for w in self.watchers:
            w(book)
        for o in self.up():
            o.activate_pgs()
        for o in self.up():
            require(o.wait_pgs_settled(WIRE_WAIT_S),
                    f"{self.what}: osd.{o.whoami}'s PGs settled after "
                    f"{name}")

    def placement_holes(self) -> dict:
        """Check that each daemon holds exactly the PGs the map gives it;
        the PGs the map left a shard short (with k + m hosts for k + m
        shards an indep walk may find no host for a shard within its
        tries: that PG starts degraded) and by how many."""
        from ceph_tpu_torch.osd.backend import CRUSH_ITEM_NONE
        from ceph_tpu_torch.osd.types import pgid_str

        holes = {}
        for p, pool in self.osdmap.pools.items():
            for seed in range(pool.pg_num):
                acting = self.osdmap.pg_to_up_acting((p, seed))[2]
                if CRUSH_ITEM_NONE in acting:
                    holes[pgid_str((p, seed))] = acting.count(
                        CRUSH_ITEM_NONE)
                for o in self.osds.values():
                    require(((p, seed) in o.pgs) == (o.whoami in acting),
                            f"{self.what}: osd.{o.whoami} holds pg "
                            f"{p}.{seed} exactly when the map puts it in "
                            f"{acting}")
        return holes

    def kill(self, i: int) -> None:
        self.osds[i].shutdown()
        self.osdmap.set_osd_down(i)
        self.refresh("kill")

    def revive(self, i: int, wrap=None, remount: bool = False) -> None:
        """A new daemon on the old store, or with ``remount`` on a new
        store object from the factory (a durable store mounted from its
        files); its new address reaches every daemon before the map that
        marks it up (as its boot message precedes that map): a peer
        answering its pull from the old address book would push to the
        dead messenger.  ``wrap(svc)`` runs before its ``init``."""
        if remount:
            self.stores[i] = self.make_store(i)
        svc = self.service(i)
        if wrap is not None:
            wrap(svc)
        svc.init()
        svc.start_heartbeats()
        self.osds[i] = svc
        self.refresh("revive_addr")
        self.osdmap.set_osd_up(i)
        self.refresh("revive")

    def shutdown(self) -> None:
        for o in self.osds.values():
            if o.up:
                o.shutdown()


def run_step(res: dict, name: str, fn) -> dict:
    """fn() as step ``name`` of ``res["steps"]``: launch counts zeroed
    before and read after, its wall beside them."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn() or {}
    wall = time.perf_counter() - t0
    out.update(wall_s=wall, counts=read_counts())
    res["steps"][name] = out
    return out


def no_threads_left(before: set, what: str) -> None:
    """Wait until no thread started since ``before`` is left (the
    process's queue worker and fan-out executor aside)."""
    deadline = time.monotonic() + WIRE_WAIT_S
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before
                and not t.name.startswith(DAEMON_SHARED_THREADS)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    require(not left, f"{what}: threads left after shutdown: {left}")


class ObjecterWatch:
    """A client objecter's placements (``_calc_target`` calls, one K6
    launch each on the card), ops and op latencies from submission to
    the final reply, counted between ``reset`` and ``read``."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.targets = 0
        self.ops: list = []
        self.lat: list = []

    def attach(self, objecter):
        """Wrap ``objecter``'s ``_calc_target`` and ``op_submit``; the
        unwrapped ``_calc_target``."""
        real_target, real_submit = objecter._calc_target, objecter.op_submit

        def calc_target(pool, oid):
            with self.lock:
                self.targets += 1
            return real_target(pool, oid)

        def op_submit(*args, on_complete=None, **kw):
            t0 = time.perf_counter()

            def completed(op):
                with self.lock:
                    self.lat.append(time.perf_counter() - t0)
                if on_complete is not None:
                    on_complete(op)

            op = real_submit(*args, on_complete=completed, **kw)
            with self.lock:
                self.ops.append(op)
            return op

        objecter._calc_target = calc_target
        objecter.op_submit = op_submit
        return real_target

    def reset(self) -> None:
        with self.lock:
            self.targets = 0
            self.ops.clear()
            self.lat.clear()

    def read(self) -> dict:
        with self.lock:
            lat = self.lat
            return {
                "objecter_k6": self.targets,
                "resends": sum(op.attempts - 1 for op in self.ops),
                "resent_ops": sum(op.attempts > 1 for op in self.ops),
                "op_s": ({"n": len(lat), "mean": sum(lat) / len(lat),
                          "max": max(lat)} if lat else {})}


def ec_shards_checked(ds: DaemonSet, pool: int, oid: str, data, plain, si,
                      only=None, whole: bool = True) -> int:
    """Each stored shard of ``oid`` (on daemon ``only``, else on every
    holder the map names) equals the plain encode of ``data`` (the codec
    on the CPU), and its ``hinfo`` CRC is the host CRC of it (``whole``;
    else, after a partial overwrite, the hinfo is marked invalid); the
    number of shards checked."""
    from ceph_tpu_torch.core.crc import crc32c
    from ceph_tpu_torch.osd import backend as ob
    from ceph_tpu_torch.osd.types import pgid_str
    from ceph_tpu_torch.store.objectstore import Collection, GHObject

    k, n = plain.k, plain.k + plain.m
    planes = si.interleave(np.asarray(data))[0]
    coding = plain.encode_array(planes)
    shards = [planes[s] if s < k else coding[s - k] for s in range(n)]
    pgid = ds.osdmap.object_to_pg(pool, oid)
    acting = ds.osdmap.pg_to_up_acting(pgid)[2]
    coll = Collection(pgid_str(pgid) + "_head")
    done = 0
    for s, osd in enumerate(acting):
        if osd == ob.CRUSH_ITEM_NONE or (only is not None and osd != only):
            continue  # a hole: CRUSH found no host for the shard
        st = ds.osds[osd].store
        go = GHObject(oid, shard=s)
        got = st.read(coll, go)
        size, hcrc, valid = ob.hinfo_decode(st.getattr(coll, go, "hinfo"))
        require(got == shards[s].tobytes(),
                f"{ds.what}: osd.{osd} {oid} shard {s} equals the plain "
                "encode")
        require(size == len(data) and (
                    valid and hcrc == crc32c(got) if whole else not valid),
                f"{ds.what}: osd.{osd} {oid} shard {s}: its hinfo CRC is "
                "the host CRC of the stored bytes" if whole else
                f"{ds.what}: osd.{osd} {oid} shard {s}: its hinfo is marked "
                "invalid after the partial overwrite")
        done += 1
    return done


def flip_at_rest(store, coll, g, nbytes: int = 16) -> int:
    """Flip ``nbytes`` of the first stored block of object ``g`` in a
    BlockStore's raw block file, behind the live store (its onode and
    blob caches dropped, as ``test_scrub_repair_blockstore.py`` does);
    the file offset flipped."""
    from ceph_tpu_torch.store.blockstore import BLOCK, _objkey

    with store._lock:
        on = store._onode(_objkey(coll, g))
        _loff, _ln, bid, boff = on.extents[0]
        blob = store._blob(bid)
        index = 0 if blob.comp else boff // BLOCK
        at = 0
        for blk, cnt in blob.pextents:
            if index < at + cnt:
                pos = (blk + index - at) * BLOCK
                break
            at += cnt
        store._dev_fh.flush()
        with open(store._dev_path, "r+b") as f:
            f.seek(pos)
            old = f.read(nbytes)
            f.seek(pos)
            f.write(bytes(b ^ 0xFF for b in old))
        store._onodes.clear()
        store._blobs.clear()
    return pos


def run_daemon(torch, dev, *, n_osds: int = DAEMON_OSDS,
               profile: str = WIRE_PROFILE, nobj: int = DAEMON_OBJS,
               obj_bytes: int = 4 * MiB, stripe_bytes: int = 1 * MiB,
               rep_objs: int = DAEMON_REP_OBJS,
               rep_bytes: int = DAEMON_REP_BYTES,
               overwrite=DAEMON_OVERWRITE, threads: int = 8,
               pg_num: int = DAEMON_PG_NUM,
               scrub_iv: float = DAEMON_SCRUB_IV) -> dict:
    """``n_osds`` port OSD daemons (``ceph_tpu_torch/osd/daemon.py``) on
    one map, under lockdep, driven as a cluster is:

    1. boot: one Context (``tpu_boot_warmup`` on, the staging pool at
       ``WIRE_SLOTS`` slots of an object, ``osd_op_history_size`` 256),
       one ``OSDService`` a shard, each over its own ``BlockStore`` in a
       temporary directory (no ``O_SYNC``, ``kv_kind="log"``), all on
       one ``OSDMap`` of ``daemon_map``; each ``init()`` runs
       ``DeviceWarmup`` (K1 through ``encode_planes`` and the recovery
       product, the CRC kernel, K6 through ``map_pgs``) before its
       messengers serve; then ``handle_osdmap`` with the address book
       on every daemon (one K6 launch a PG a call), ``activate_pgs``,
       ``wait_pgs_settled`` and ``start_heartbeats``;
    2. write: ``client.4100``, a raw messenger, sends each of ``nobj``
       seeded objects of ``obj_bytes`` to pool A as one ``WRITEFULL``
       ``MOSDOp`` to its acting primary (``object_to_pg`` ->
       ``pg_to_up_acting``), from ``threads`` threads, and ``rep_objs``
       small ones to pool B; the primary's ``ms_dispatch`` classifies the
       op (``qos.classify_op``) and queues it on the mclock workqueue,
       whose worker calls ``PG.do_op``: the ``encp`` batch (K1 + CRC)
       and one ``MECSubWriteVec`` a holder.  Checked: every reply 0;
       every stored shard, read through its extent seals, equals the
       plain encode (the codec on the CPU) and its ``hinfo`` CRC the
       host CRC of it; every PG's ``last_update`` equal on all its
       holders; each primary's ``osd.N.qos`` ``admitted_client`` moved
       by the ops sent to it; every op in some ``dump_historic_ops``;
       then ``rmw``: ``DAEMON_RMW_OBJS`` pool A objects take an offset
       ``WRITE`` (the partial-stripe RMW, whose old-stripe sub-reads are
       ranged: ``read_local_chunk_extent2``, served from the stores'
       own checksums at rest);
    3. degraded read: the primary of pool B's first object's PG shuts
       down, is marked down in the map, and every daemon takes the map
       (``handle_osdmap``, ``activate_pgs``: peering through
       ``collect_pg_infos``); every object read back by ``READ``
       ``MOSDOp``, byte for byte, pool A through ``_ec_read_object`` ->
       ``reconstruct_async`` (K1 ``dec``) where a data shard is lost;
    4. recover: while it is down, ``overwrite`` objects of pools A and B
       are rewritten (pool B's first the ones of PGs it leads); then a
       new ``OSDService`` on a new ``BlockStore`` mounted from its
       directory (its KV log replayed), ``set_osd_up``, the map and
       activation everywhere: its PGs catch up through peering, the
       recovery engine on pool A (K1), ``pull_from_peer`` on pool B
       (counted) and the primaries' pushes to it; the step ends when
       ``missing`` is empty everywhere and every PG's ``last_update``
       agrees on its holders; every shard and ``hinfo`` on it equal to
       the plain encode, pool B's copies to the data;
    5. rot at rest: bytes of a data shard of object 0 flipped in its
       holder's block file (a holder that is not its primary;
       ``flip_at_rest``), and in turn ``rot_read`` (the store refuses
       them, the READ answers ECRC's attribution and decodes around it
       on K1), ``scrub`` (``start_scrub_scheduler`` on the primary until
       the cluster log's ``deep-scrub`` ERR names the object;
       ``osd.N.qos`` ``admitted_scrub`` moved) and ``repair``
       (``PG.repair`` rebuilds the shard; it reads clean from its store
       and through a READ);
    6. every daemon and the client shut down, and no thread they started
       is left (the process's queue worker and fan-out executor aside).

    Launch counts are zeroed before and read after each step and each
    map refresh.  Each step also carries the stores' ``queued_txns`` and
    ``dev_fsyncs`` (0 without ``O_SYNC``: the apply is the commit
    point) and the backends' ``osd.N.pg`` counts of ranged shard reads
    by the branch each took: ``extent_reads_at_rest`` (served straight
    from the store, whose reads verify at rest) or
    ``extent_reads_whole_chunk`` (the whole chunk read and its hinfo
    CRC checked), and ``laggard_retries``, the laggards that a primary's
    watchdog pushed forward again after a push to them failed.  Returns the counts, walls, warmup stats and checks;
    raises on any failed check."""
    import os
    import tempfile

    from ceph_tpu_torch.core import lockdep
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import default_queue
    from ceph_tpu_torch.msg.message import EntityName
    from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
    from ceph_tpu_torch.osd import backend as ob
    from ceph_tpu_torch.osd import messages as om
    from ceph_tpu_torch.osd.ecutil import StripeInfo
    from ceph_tpu_torch.osd.types import OP_READ, OP_WRITE, OP_WRITEFULL
    from ceph_tpu_torch.osd.types import OSDOp, pgid_str
    from ceph_tpu_torch.store.blockstore import BlockStore
    from ceph_tpu_torch.store.objectstore import (ChecksumError, Collection,
                                                  GHObject)

    unit = codec_from_profile(profile, device=dev).get_chunk_size(
        stripe_bytes)
    ec_profile = f"{profile} stripe_unit={unit}"
    plain = codec_from_profile(ec_profile, device="cpu")
    k, m = plain.k, plain.m
    n = k + m
    require(n == n_osds, f"daemon: one daemon a shard ({n} != {n_osds})")
    si = StripeInfo(k, unit)
    A, B = DAEMON_EC_POOL, DAEMON_REP_POOL
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    objs = torch.randint(0, 256, (nobj + overwrite[0], obj_bytes),
                         dtype=torch.uint8, device=dev,
                         generator=g).cpu().numpy()
    rng = np.random.default_rng(SEED + 21)
    reps = [rng.integers(0, 256, rep_bytes, dtype=np.uint8).tobytes()
            for _ in range(rep_objs + overwrite[1])]
    oids = [f"rbd_data.{i:016x}" for i in range(nobj)]
    roids = [f"rep.{i:04d}" for i in range(rep_objs)]
    want = {(A, oids[i]): objs[i] for i in range(nobj)}
    want.update({(B, roids[i]): reps[i] for i in range(rep_objs)})

    osdmap = daemon_map(dev, n_osds, ec_profile, k, pg_num)
    tmp = tempfile.TemporaryDirectory(prefix="daemon-blockstore-")

    def factory(i: int):
        return BlockStore(os.path.join(tmp.name, f"osd{i}"), o_sync=False,
                          kv_kind="log")
    before_threads = {t.ident for t in threading.enumerate()}
    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    ctx = Context("osd.cluster", {
        "tpu_boot_warmup": True,
        "tpu_staging_slot_kib": max(1, obj_bytes >> 10),
        "tpu_staging_slots": WIRE_SLOTS,
        "osd_op_history_size": 256})
    ds = DaemonSet(dev, ctx, osdmap, n_osds, "daemon", store_factory=factory)
    osds = ds.osds
    client = None
    res: dict = {"steps": {}, "refresh": ds.refreshes}
    cond = threading.Condition()
    replies: dict = {}
    tids = iter(range(1, 1 << 30))
    sent: dict = {}     # MOSDOps sent to each primary, resends included
    acked: dict = {}    # answered 0 by each
    retries = [0]
    dq = default_queue(dev)

    class ClientD(Dispatcher):
        def ms_can_fast_dispatch(self, msg) -> bool:
            return True

        def ms_dispatch(self, conn, msg) -> bool:
            if not isinstance(msg, om.MOSDOpReply):
                return False
            with cond:
                replies[msg.tid] = msg
                cond.notify_all()
            return True

    def op(pool: int, oid: str, ops):
        """One MOSDOp to the acting primary, resent (same tid and reqid)
        while the answer is EAGAIN or ESTALE, as the objecter does."""
        with cond:
            tid = next(tids)
        deadline = time.monotonic() + WIRE_WAIT_S
        while True:
            pgid = osdmap.object_to_pg(pool, oid)
            primary = osdmap.pg_to_up_acting(pgid)[3]
            msg = om.MOSDOp(pgid, osdmap.epoch, oid, ops)
            msg.tid = tid
            msg.reqid = f"client.{WIRE_CLIENT}.0:{tid}"
            with cond:
                sent[primary] = sent.get(primary, 0) + 1
            client.send_message(msg, osds[primary].addr)
            with cond:
                require(cond.wait_for(
                    lambda: tid in replies,
                    max(0.0, deadline - time.monotonic())),
                    f"daemon: a reply to {oid} (tid {tid})")
                rep = replies.pop(tid)
            if rep.result not in (-11, -116):
                if rep.result == 0:
                    with cond:
                        acked[primary] = acked.get(primary, 0) + 1
                return rep
            require(time.monotonic() < deadline,
                    f"daemon: {oid} still answered {rep.result}")
            with cond:
                retries[0] += 1
            time.sleep(0.05)

    def write(pool: int, oid: str, data) -> None:
        rep = op(pool, oid, [OSDOp(OP_WRITEFULL, data=memoryview(data))])
        require(rep.result == 0,
                f"daemon: the write of {oid} answered {rep.result}")
        want[(pool, oid)] = data

    def read(pool: int, oid: str) -> None:
        rep = op(pool, oid, [OSDOp(OP_READ)])
        data = want[(pool, oid)]
        require(rep.result == 0 and rep.ops[0].out_data == bytes(data),
                f"daemon: the read of {oid} answered {rep.result} with "
                f"{len(rep.ops[0].out_data) if rep.ops else 0} bytes")

    def store_counts() -> dict:
        """Each store's commit counts and each daemon's PG counts, by
        the object that keeps them (a revived daemon and its store start
        new ones)."""
        out = {(id(st_), c): st_.perf.value(c)
               for st_ in ds.stores.values() for c in DAEMON_STORE_COUNTS}
        out.update({(id(o.pg_perf), c): o.pg_perf.value(c)
                    for o in osds.values() for c in DAEMON_PG_COUNTS})
        return out

    def step(name: str, fn) -> dict:
        c0 = store_counts()
        out = run_step(res, name, fn)
        for c in DAEMON_STORE_COUNTS + DAEMON_PG_COUNTS:
            out[c] = sum(v - c0.get(key, 0)
                         for key, v in store_counts().items() if key[1] == c)
        return out

    def holders_agree() -> dict:
        """Every PG's last_update on each of its live holders, once they
        agree (a holder notes an entry a moment after its ack)."""
        deadline = time.monotonic() + WIRE_WAIT_S
        while True:
            seen = {}
            for o in ds.up():
                for pgid, pg in list(o.pgs.items()):
                    if o.whoami in pg.acting:
                        seen.setdefault(pgid, set()).add(
                            (pg.info.last_update.epoch,
                             pg.info.last_update.version))
            bad = {p: v for p, v in seen.items() if len(v) > 1}
            if not bad or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        # on failure: each holder's view of each disagreeing PG
        views = {pgid_str(p): {
            o.whoami: (str(pg.info.last_update), pg.state,
                       pg.primary, sorted(pg.stale_peers),
                       sorted(pg.missing))
            for o in ds.up() for q, pg in list(o.pgs.items()) if q == p}
            for p in bad}
        require(not bad, f"daemon: every PG's last_update agrees on its "
                         f"holders: {bad} (osd: last_update, state, "
                         f"primary, stale peers, missing: {views})")
        return {pgid_str(p): sorted(v)[0] for p, v in sorted(seen.items())}

    rmw_set: set = set()

    def check_ec(i: int, only=None) -> int:
        """Object i of pool A on its holders (``only``: that daemon); an
        object an offset WRITE touched carries an invalid whole-chunk
        hinfo, as Ceph's does after a partial overwrite."""
        return ec_shards_checked(ds, A, oids[i], want[(A, oids[i])], plain,
                                 si, only, whole=i not in rmw_set)

    try:
        # 1. boot
        def boot():
            ds.boot()
            return {"warmup": osds[0]._warmup.stats(),
                    "warmup_s": [round(o._warmup.stats()["seconds"], 3)
                                 for o in osds.values()]}

        wu = step("warmup", boot)
        for o in osds.values():
            st = o._warmup.stats()
            require(st["done"] and not st["skipped"]
                    and st["families_warmed"] == ["crc32c_rows",
                                                  "crush_rule", "dec",
                                                  "enc"],
                    f"daemon: osd.{o.whoami}'s boot warmup launched every "
                    f"declared bucket {st}")
        res["warmup"] = wu["warmup"]
        ds.refresh("boot")
        res["holes"] = ds.placement_holes()
        for o in osds.values():
            o.start_heartbeats()
        client = Messenger(Context(f"client.{WIRE_CLIENT}"),
                           EntityName("client", WIRE_CLIENT))
        client.add_dispatcher(ClientD())
        client.start()

        # 2. write
        qos0 = {i: o.qos.perf.dump().get("admitted_client", 0)
                for i, o in osds.items()}
        with cond:
            sent.clear()
            acked.clear()

        def writes():
            wall_a = run_threads(lambda i: write(A, oids[i], objs[i]),
                                 nobj, threads)
            wall_b = run_threads(lambda i: write(B, roids[i], reps[i]),
                                 rep_objs, threads)
            return {"wall_a_s": wall_a, "wall_b_s": wall_b}

        w = step("write", writes)
        w["gbs"] = nobj * obj_bytes / w["wall_a_s"] / 1e9
        w["heads"] = holders_agree()
        w["ec_shards_checked"] = sum(check_ec(i) for i in range(nobj))
        for i in range(rep_objs):
            pgid = osdmap.object_to_pg(B, roids[i])
            coll = Collection(pgid_str(pgid) + "_head")
            for osd in osdmap.pg_to_up_acting(pgid)[2]:
                require(osds[osd].store.read(coll, GHObject(roids[i]))
                        == reps[i], f"daemon: osd.{osd} holds {roids[i]}")
        admitted = {i: o.qos.perf.dump().get("admitted_client", 0) - qos0[i]
                    for i, o in osds.items()}
        require(all(acked.get(i, 0) <= admitted[i] <= sent.get(i, 0)
                    for i in osds) and sum(acked.values()) == nobj + rep_objs,
                f"daemon: each primary's osd.N.qos admitted the client ops "
                f"it served: {admitted}, sent {sent}, acked {acked}")
        w["admitted_client"] = admitted
        hist = set()
        for o in osds.values():
            for h in o.op_tracker.dump_historic()["ops"]:
                hist.add(h["description"].split(" ")[2])
        missing_hist = [x for x in oids + roids if x not in hist]
        require(not missing_hist,
                f"daemon: every op in some dump_historic_ops "
                f"({len(missing_hist)} missing)")
        # an offset WRITE into the last objects: the partial-stripe RMW
        # reads its old stripe from the peers as ranged extents
        ext_off = stripe_bytes + stripe_bytes // 128
        ext_len = stripe_bytes // 16

        def rmws():
            for j in range(DAEMON_RMW_OBJS):
                i = nobj - 1 - j
                patch = objs[j][:ext_len]
                rep = op(A, oids[i], [OSDOp(OP_WRITE, off=ext_off,
                                            data=patch.tobytes())])
                require(rep.result == 0,
                        f"daemon: the offset write of {oids[i]} answered "
                        f"{rep.result}")
                new = np.array(want[(A, oids[i])])
                new[ext_off:ext_off + ext_len] = patch
                want[(A, oids[i])] = new
                rmw_set.add(i)
            return {"objects": DAEMON_RMW_OBJS, "bytes": ext_len,
                    "offset": ext_off}

        rm = step("rmw", rmws)
        rm["ec_shards_checked"] = sum(check_ec(i) for i in rmw_set)
        require(rm["extent_reads_at_rest"] > 0
                and rm["extent_reads_whole_chunk"] == 0,
                f"daemon: the backends served the RMW's ranged sub-reads "
                f"straight from the BlockStores, which verify at rest "
                f"({rm['extent_reads_at_rest']} at rest, "
                f"{rm['extent_reads_whole_chunk']} whole chunk)")

        # 3. degraded read: the daemon leading pool B's first object's
        # PG goes down (so its revival pulls that PG from a peer)
        down = osdmap.pg_to_up_acting(osdmap.object_to_pg(B, roids[0]))[3]
        res["down"] = down
        led = [x for x in roids
               if osdmap.pg_to_up_acting(osdmap.object_to_pg(B, x))[3]
               == down]
        rew_b = (led + [x for x in roids if x not in led])[:overwrite[1]]
        step("kill", lambda: ds.kill(down))
        lost_data = 0
        for i in range(nobj):
            acting = osdmap.pg_to_up_acting(
                osdmap.object_to_pg(A, oids[i]))[2]
            lost_data += any(acting[s] == ob.CRUSH_ITEM_NONE
                             for s in range(k))
        dec0 = sum(w_ * c for w_, c in dq.dec_batch_jobs.items())

        def reads():
            wall_a = run_threads(lambda i: read(A, oids[i]), nobj, threads)
            wall_b = run_threads(lambda i: read(B, roids[i]), rep_objs,
                                 threads)
            return {"wall_a_s": wall_a, "wall_b_s": wall_b}

        r = step("read", reads)
        r["gbs"] = nobj * obj_bytes / r["wall_a_s"] / 1e9
        r["lost_data_objects"] = lost_data
        r["dec_jobs"] = sum(w_ * c for w_, c in dq.dec_batch_jobs.items()) \
            - dec0
        require(lost_data > 0 and r["dec_jobs"] >= lost_data,
                f"daemon: the read decoded every object that lost a data "
                f"shard ({r['dec_jobs']} dec jobs, {lost_data} objects)")

        # 4. writes while down, then the revival and the catch-up
        def writes_down():
            for j in range(overwrite[0]):
                write(A, oids[j], objs[nobj + j])
            for j, x in enumerate(rew_b):
                write(B, x, reps[rep_objs + j])
            return {"objects": overwrite[0] + len(rew_b)}

        step("write_down", writes_down)
        pulls = []

        def count_pulls(svc):
            real_pull = svc.pull_from_peer

            def pull_from_peer(pg, best, since, defer_recovery=False):
                pulls.append((pgid_str(pg.pgid), best))
                return real_pull(pg, best, since,
                                 defer_recovery=defer_recovery)

            svc.pull_from_peer = pull_from_peer

        def revive():
            ds.revive(down, count_pulls, remount=True)
            deadline = time.monotonic() + WIRE_WAIT_S
            while (any(pg.missing for o in ds.up() for pg in o.pgs.values())
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            left = {f"osd.{o.whoami} {pgid_str(p)} {pg.state}":
                    sorted(pg.missing)
                    for o in ds.up() for p, pg in o.pgs.items() if pg.missing}
            require(not left, f"daemon: missing is empty on every PG after "
                              f"the revival: {left}")
            # caught up: every holder at its PG's head
            return {"heads": holders_agree()}

        rv = step("recover", revive)
        rv["pulls"] = pulls
        require(any(p.startswith(f"{B}.") for p, _ in pulls),
                f"daemon: the revived daemon pulled pool B from a peer "
                f"{pulls}")
        rv["ec_shards_checked"] = sum(check_ec(i, only=down)
                                      for i in range(nobj))
        for x in roids:
            pgid = osdmap.object_to_pg(B, x)
            if down in osdmap.pg_to_up_acting(pgid)[2]:
                coll = Collection(pgid_str(pgid) + "_head")
                require(osds[down].store.read(coll, GHObject(x))
                        == want[(B, x)],
                        f"daemon: the revived osd.{down} holds {x}")
        rv["objs_per_s"] = (overwrite[0] + len(rew_b)) / rv["wall_s"]

        # 5. rot at rest: read around, found by the scheduled deep
        # scrub, repaired
        oid = oids[0]
        pgid = osdmap.object_to_pg(A, oid)
        acting = osdmap.pg_to_up_acting(pgid)[2]
        prim = osdmap.pg_to_up_acting(pgid)[3]
        shard = next(s for s, o in enumerate(acting)
                     if o not in (prim, ob.CRUSH_ITEM_NONE) and s < k)
        holder = acting[shard]
        coll = Collection(pgid_str(pgid) + "_head")
        gs = GHObject(oid, shard=shard)
        hits = []
        found = threading.Event()

        def cluster_cb(lvl, msg):
            hits.append((lvl, msg))
            if lvl == "ERR" and "deep-scrub" in msg and oid in msg:
                found.set()

        ctx.log.cluster_cb = cluster_cb
        psvc = osds[prim]
        ppg = psvc.pgs[pgid]
        good = osds[holder].store.read(coll, gs)
        res["rot_at"] = flip_at_rest(osds[holder].store, coll, gs)
        try:
            osds[holder].store.read(coll, gs)
            refused = False
        except ChecksumError:
            refused = True
        require(refused, f"daemon: osd.{holder}'s BlockStore refuses the "
                         f"flipped blocks of {oid} shard {shard}")

        def rot_read():
            ppg._obc_invalidate()
            d0 = sum(w_ * c for w_, c in dq.dec_batch_jobs.items())
            read(A, oid)
            return {"dec_jobs": sum(w_ * c for w_, c in
                                    dq.dec_batch_jobs.items()) - d0}

        rr = step("rot_read", rot_read)
        rr["errors"] = [msg for lvl, msg in hits
                        if lvl == "ERR" and "at-rest" in msg]
        require(rr["dec_jobs"] >= 1 and any(oid in e for e in rr["errors"]),
                f"daemon: the read of {oid} refused shard {shard} and "
                f"decoded around it: {rr['dec_jobs']} dec jobs, "
                f"{rr['errors']}")
        sq0 = psvc.qos.perf.dump().get("admitted_scrub", 0)

        def scrub():
            psvc.start_scrub_scheduler(interval=scrub_iv)
            require(found.wait(WIRE_WAIT_S),
                    f"daemon: the scheduled deep scrub named {oid}: {hits}")
            return {}

        sc = step("scrub", scrub)
        sc["admitted_scrub"] = (psvc.qos.perf.dump().get("admitted_scrub", 0)
                                - sq0)
        require(sc["admitted_scrub"] > 0,
                "daemon: osd.N.qos admitted the scheduled scrub's chunks")
        sc.update(primary=prim, shard=shard, holder=holder,
                  errors=[msg for lvl, msg in hits if lvl == "ERR"],
                  scrubs=[r_ for r_ in psvc.dump_scrubs()["scrubs"]
                          if r_["last_deep_scrub"]])

        def repair():
            # the scheduler skips a PG whose guard is held
            require(ppg.maintenance_guard.acquire(timeout=WIRE_WAIT_S),
                    f"daemon: the repair of pg {pgid_str(pgid)} got its "
                    "maintenance guard")
            try:
                post = ppg.repair()
            finally:
                ppg.maintenance_guard.release()
            require(post.get(oid) is None,
                    f"daemon: the repair healed {oid}: {post}")
            require(osds[holder].store.read(coll, gs) == good,
                    f"daemon: osd.{holder} reads {oid} shard {shard} clean "
                    "after the repair")
            ppg._obc_invalidate()
            read(A, oid)
            return {"post_errors": sorted(post)}

        rp = step("repair", repair)
        rp["ec_shards_checked"] = check_ec(0, only=holder)
        res["edges"] = sum(len(v) for v in lockdep.edge_graph().values())
    finally:
        ds.shutdown()
        if client is not None:
            client.shutdown()
        lockdep.enable(was)
        res["store_bytes"] = {
            name: sum(os.path.getsize(os.path.join(tmp.name, d, name))
                      for d in os.listdir(tmp.name)
                      if os.path.exists(os.path.join(tmp.name, d, name)))
            for name in ("block", "meta.kv")}
        tmp.cleanup()

    # 6. nothing the daemons started is left
    no_threads_left(before_threads, "daemon")
    res.update(retries=retries[0], sent=dict(sent))
    return res


def phase_daemon(torch, dev, log) -> dict:
    """The ``daemon`` phase: ``run_daemon`` at full width on BlockStores,
    twelve port OSD daemons (isa k=8 m=4 over all twelve, a replicated
    pool of size 3) on one map, the revived one on a new BlockStore
    mounted from its directory.  The warmup must launch K1, the CRC
    kernel and K6; a map refresh K6; the write K1 and the CRC kernel;
    the offset writes, the read, the recovery, the read around the rot,
    the scrub and the repair K1."""
    res = run_daemon(torch, dev)
    st = res["steps"]
    for name, need in (("warmup", ("gf256_matmul", "crc32c_rows",
                                   "crush_rule")),
                       ("write", ("gf256_matmul", "crc32c_rows")),
                       ("rmw", ("gf256_matmul",)),
                       ("read", ("gf256_matmul",)),
                       ("recover", ("gf256_matmul",)),
                       ("rot_read", ("gf256_matmul",)),
                       ("scrub", ("gf256_matmul",)),
                       ("repair", ("gf256_matmul",))):
        require(all(st[name]["counts"][x] > 0 for x in need),
                f"daemon: the {name} step ran {list(need)}: "
                f"{st[name]['counts']}")
    require(all(r["k6"] > 0 for r in res["refresh"]),
            f"daemon: every map refresh walked K6 {res['refresh']}")
    wu = res["warmup"]
    log(f"daemon warmup: {wu['buckets_warmed']} buckets "
        f"({', '.join(wu['families_warmed'])}) in {wu['seconds']} s on "
        f"osd.0; per daemon {json.dumps(st['warmup']['warmup_s'])} s; "
        f"launches {json.dumps(st['warmup']['counts'])}")
    log(f"daemon refreshes (handle_osdmap on every daemon, one K6 launch "
        f"a PG a call): {json.dumps(res['refresh'])}; PGs the map left a "
        f"shard short (no host found within the rule's tries): "
        f"{json.dumps(res['holes'])}")
    w, r, rv, sc = st["write"], st["read"], st["recover"], st["scrub"]
    rm, rr, rp = st["rmw"], st["rot_read"], st["repair"]
    launches = {name: {x: v for x, v in s["counts"].items() if v}
                for name, s in st.items()}
    log(f"daemon: {DAEMON_OSDS} OSDService on BlockStores (no O_SYNC, "
        f"kv_kind log; isa k=8 m=4 pool, size 12, {DAEMON_PG_NUM} PGs; "
        f"replicated pool, size 3, {DAEMON_PG_NUM} PGs) on one map under "
        f"lockdep: {DAEMON_OBJS} x 4 MiB WRITEFULL MOSDOp from "
        f"client.{WIRE_CLIENT} to each acting primary (ms_dispatch -> the "
        f"mclock wq -> PG.do_op -> encp) {w['gbs']:.3f} GB/s "
        f"({w['wall_a_s']:.3f} s), {DAEMON_REP_OBJS} x 64 KiB to the "
        f"replicated pool {w['wall_b_s']:.3f} s; every shard equal to the "
        f"plain encode and its hinfo to the host CRC "
        f"({w['ec_shards_checked']} shards); {rm['objects']} offset "
        f"WRITEs of {rm['bytes']} B in {rm['wall_s']:.3f} s; "
        f"osd.{res['down']} down: degraded READ {r['gbs']:.3f} GB/s "
        f"({r['wall_a_s']:.3f} s, {r['dec_jobs']} dec jobs, "
        f"{r['lost_data_objects']} objects lost a data shard); "
        f"{sum(DAEMON_OVERWRITE)} objects rewritten while down, revived "
        f"on a new BlockStore mounted from its directory and caught up in "
        f"{rv['wall_s']:.3f} s ({rv['objs_per_s']:.2f} objects/s; pulls "
        f"{rv['pulls']}; {rv['ec_shards_checked']} shards on it equal to "
        f"the plain encode); shard {sc['shard']} of object 0 flipped in "
        f"osd.{sc['holder']}'s block file at {res['rot_at']}: refused by "
        f"its store, the READ decoded around it ({rr['dec_jobs']} dec "
        f"jobs, {rr['wall_s']:.3f} s), the scheduled deep scrub named it "
        f"in {sc['wall_s']:.3f} s (admitted_scrub {sc['admitted_scrub']}), "
        f"the repair healed it in {rp['wall_s']:.3f} s and it reads "
        f"clean; launches {json.dumps(launches)}; {res['edges']} "
        f"lock-order edges; retries {res['retries']}; no thread left")
    log("daemon stores: " + json.dumps({
        "bytes": res["store_bytes"],
        "steps": {name: {x: s[x] for x in ("wall_s", *DAEMON_STORE_COUNTS,
                                           *DAEMON_PG_COUNTS)}
                  for name, s in st.items()}}))
    return res


CLUSTER_CLIENT = 4200         # the RadosClient's entity: client.4200
CLUSTER_OBJS = 32             # 4 MiB objects the client writes to pool A,
#                               cut from 64 for the script's time limit
CLUSTER_INFLIGHT = 8          # pool A writes in flight when their primary dies
# Reads go one at a time: the objecter re-sends an op unanswered for 1 s
# (its resend_interval, the reference's), and the PG runs every copy of a
# read, so concurrent 4 MiB degraded reads (about 0.4 s of host work each)
# feed on their own resends until they time out
CLUSTER_READ_THREADS = 1
# the striped object: 64 MiB over 1 MiB units, 4 objects wide, 4 MiB objects
CLUSTER_STRIPED = (64 * MiB, 1 * MiB, 4, 4 * MiB)


def run_cluster(torch, dev, *, n_osds: int = DAEMON_OSDS,
                profile: str = WIRE_PROFILE, nobj: int = CLUSTER_OBJS,
                obj_bytes: int = 4 * MiB, stripe_bytes: int = 1 * MiB,
                rep_objs: int = DAEMON_REP_OBJS,
                rep_bytes: int = DAEMON_REP_BYTES, threads: int = 8,
                pg_num: int = DAEMON_PG_NUM,
                inflight: int = CLUSTER_INFLIGHT,
                striped=CLUSTER_STRIPED) -> dict:
    """The client over ``n_osds`` port OSD daemons on ``daemon_map``
    (booted, refreshed and stopped by ``DaemonSet``, as ``run_daemon``
    does), under lockdep: one port ``RadosClient`` on ``dev``,
    ``inject_osdmap``ed and handed every map refresh, whose objecter
    places each op (``_calc_target``: one ``pg_to_up_acting``, one K6
    launch on the card, a send and each resend) and resends it on a map
    change, on ``EAGAIN``/``ESTALE`` and on its 1 s timer:

    1. write: ``nobj`` seeded objects of ``obj_bytes`` to pool A by
       ``IoCtx.aio_operate`` ``WRITEFULL`` from ``threads`` threads (the
       ``encp`` batch: K1 + CRC), ``rep_objs`` of ``rep_bytes`` to pool
       B; every reply 0, every stored shard equal to the plain encode and
       its ``hinfo`` to the host CRC, pool B's copies on every holder;
    2. failover: ``inflight`` new pool-A objects whose PGs one daemon
       leads are submitted, that daemon shuts down, is marked down and
       the map refreshed: every op completes with 0 through the
       objecter's resend, and each object's PG log holds exactly one
       entry for its reqid;
    3. read: every object read back by ``IoCtx.read``, one at a time
       (``CLUSTER_READ_THREADS``), byte for byte, pool A through
       ``reconstruct_async`` (K1 ``dec``) where a data shard is lost;
    4. stripe: one object of ``striped[0]`` bytes through
       ``RadosStriper(stripe_unit=striped[1], stripe_count=striped[2],
       object_size=striped[3])`` on pool A (its writes all at once),
       read back whole, one stripe of units a call (one read an object
       at a time in flight on each of ``stripe_count`` objects), and at
       an unaligned offset, each component object's shards equal to
       the plain encode;
    5. the client and every daemon shut down, no thread left.

    Launch counts are zeroed before and read after each step; the
    objecter's ``_calc_target`` calls, resends and the queue's ``encp``
    and ``dec`` batch widths are counted per step.  Raises on any failed
    check."""
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.client.striper import RadosStriper
    from ceph_tpu_torch.core import lockdep
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import default_queue
    from ceph_tpu_torch.msg.message import EntityName
    from ceph_tpu_torch.osd import backend as ob
    from ceph_tpu_torch.osd.ecutil import StripeInfo
    from ceph_tpu_torch.osd.types import OP_WRITEFULL, OSDOp, pgid_str
    from ceph_tpu_torch.store.objectstore import Collection, GHObject

    unit = codec_from_profile(profile, device=dev).get_chunk_size(
        stripe_bytes)
    ec_profile = f"{profile} stripe_unit={unit}"
    plain = codec_from_profile(ec_profile, device="cpu")
    k = plain.k
    require(k + plain.m == n_osds,
            f"cluster: one daemon a shard ({k + plain.m} != {n_osds})")
    si = StripeInfo(k, unit)
    A, B = DAEMON_EC_POOL, DAEMON_REP_POOL
    s_bytes, s_unit, s_count, s_obj = striped
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    objs = torch.randint(0, 256, (nobj + inflight, obj_bytes),
                         dtype=torch.uint8, device=dev,
                         generator=g).cpu().numpy()
    rng = np.random.default_rng(SEED + 31)
    reps = [rng.integers(0, 256, rep_bytes, dtype=np.uint8).tobytes()
            for _ in range(rep_objs)]
    big = rng.integers(0, 256, s_bytes, dtype=np.uint8).tobytes()
    want = {(A, f"obj.{i:04d}"): objs[i] for i in range(nobj)}
    want.update({(B, f"rep.{i:04d}"): reps[i] for i in range(rep_objs)})

    osdmap = daemon_map(dev, n_osds, ec_profile, k, pg_num)
    before_threads = {t.ident for t in threading.enumerate()}
    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    ctx = Context("osd.cluster", {
        "tpu_boot_warmup": True,
        "tpu_staging_slot_kib": max(1, obj_bytes >> 10),
        "tpu_staging_slots": WIRE_SLOTS})
    ds = DaemonSet(dev, ctx, osdmap, n_osds, "cluster")
    osds = ds.osds
    rc = None
    res: dict = {"steps": {}, "refresh": ds.refreshes}
    dq = default_queue(dev)
    watch = ObjecterWatch()

    def widths(d: dict, d0: dict) -> dict:
        return {w: c - d0.get(w, 0) for w, c in sorted(d.items())
                if c - d0.get(w, 0)}

    def step(name: str, fn) -> dict:
        watch.reset()
        enc0, dec0 = dict(dq.batch_jobs), dict(dq.dec_batch_jobs)
        out = run_step(res, name, fn)
        out.update(watch.read())
        out["encp_widths"] = widths(dq.batch_jobs, enc0)
        out["dec_widths"] = widths(dq.dec_batch_jobs, dec0)
        return out

    def put(io, oid: str, data):
        return io.aio_operate(oid, [OSDOp(OP_WRITEFULL,
                                          data=memoryview(data))],
                              timeout=WIRE_WAIT_S)

    def done(op) -> None:
        rep = op.result(WIRE_WAIT_S)
        require(rep.result == 0,
                f"cluster: the write of {op.oid} answered {rep.result}")

    def get(io, pool: int, oid: str) -> None:
        got = io.read(oid)
        require(got == bytes(want[(pool, oid)]),
                f"cluster: {oid} read back byte for byte ({len(got)} "
                "bytes)")

    def replicas_held() -> None:
        for (pool, oid), data in want.items():
            if pool != B:
                continue
            pgid = osdmap.object_to_pg(B, oid)
            coll = Collection(pgid_str(pgid) + "_head")
            for osd in osdmap.pg_to_up_acting(pgid)[2]:
                require(osds[osd].store.read(coll, GHObject(oid)) == data,
                        f"cluster: osd.{osd} holds {oid}")

    try:
        # boot: the daemons, then the client on the map they share
        def boot():
            ds.boot()
            ds.refresh("boot")
            return {"holes": ds.placement_holes()}

        res["holes"] = step("boot", boot)["holes"]
        for o in osds.values():
            o.start_heartbeats()
        rc = RadosClient(Context(f"client.{CLUSTER_CLIENT}"),
                         EntityName("client", CLUSTER_CLIENT), device=dev)
        rc.inject_osdmap(osdmap, ds.book())
        ds.watchers.append(
            lambda book: rc.objecter.handle_osdmap(osdmap, book))
        real_target = watch.attach(rc.objecter)  # the striper's ops too
        reset_counts()
        real_target(A, "probe")
        res["k6_per_target"] = read_counts()["crush_rule"]
        io_a, io_b = rc.ioctx(A), rc.ioctx(B)

        # 1. write
        def writes():
            wall_a = run_threads(lambda i: done(put(
                io_a, f"obj.{i:04d}", objs[i])), nobj, threads)
            wall_b = run_threads(lambda i: done(put(
                io_b, f"rep.{i:04d}", reps[i])), rep_objs, threads)
            return {"wall_a_s": wall_a, "wall_b_s": wall_b}

        w = step("write", writes)
        w["gbs"] = nobj * obj_bytes / w["wall_a_s"] / 1e9
        w["ec_shards_checked"] = sum(
            ec_shards_checked(ds, A, f"obj.{i:04d}", objs[i], plain, si)
            for i in range(nobj))
        replicas_held()

        # 2. failover: writes in flight to the PGs one daemon leads
        down = osdmap.pg_to_up_acting(osdmap.object_to_pg(A, "obj.0000"))[3]
        res["down"] = down
        fos = list(itertools.islice(
            (x for x in (f"failover.{j:04d}" for j in range(1 << 16))
             if osdmap.pg_to_up_acting(osdmap.object_to_pg(A, x))[3]
             == down), inflight))

        def failover():
            sent = [put(io_a, x, objs[nobj + j]) for j, x in enumerate(fos)]
            early = sum(op.event.is_set() for op in sent)
            ds.kill(down)
            for op in sent:
                done(op)
            return {"objects": len(sent), "answered_before_kill": early}

        fo = step("failover", failover)
        for j, x in enumerate(fos):
            want[(A, x)] = objs[nobj + j]
        once = {}
        for op in watch.ops:
            pgid = osdmap.object_to_pg(A, op.oid)
            prim = osdmap.pg_to_up_acting(pgid)[3]
            require(prim != down, f"cluster: {op.oid} has a new primary")
            once[op.oid] = sum(e.reqid == op.reqid
                               for e in osds[prim].pgs[pgid].log.entries)
        require(len(once) == len(fos) and set(once.values()) == {1},
                f"cluster: each failover object's PG log holds one entry "
                f"for its reqid {once}")
        fo["ec_shards_checked"] = sum(
            ec_shards_checked(ds, A, x, objs[nobj + j], plain, si)
            for j, x in enumerate(fos))

        # 3. degraded read of every object.  The objects written before
        # the kill must decode where a data shard is lost (the map
        # change emptied the PGs' object context caches); the failover
        # objects may come from the new primary's cache
        lost = sum(any(a == ob.CRUSH_ITEM_NONE for a in osdmap.pg_to_up_acting(
            osdmap.object_to_pg(A, f"obj.{i:04d}"))[2][:k])
            for i in range(nobj))
        keys_a = sorted(oid for pool, oid in want if pool == A)

        def reads():
            wall_a = run_threads(lambda i: get(io_a, A, keys_a[i]),
                                 len(keys_a), CLUSTER_READ_THREADS)
            wall_b = run_threads(lambda i: get(io_b, B, f"rep.{i:04d}"),
                                 rep_objs, CLUSTER_READ_THREADS)
            return {"wall_a_s": wall_a, "wall_b_s": wall_b}

        r = step("read", reads)
        r["gbs"] = len(keys_a) * obj_bytes / r["wall_a_s"] / 1e9
        r["lost_data_objects"] = lost
        r["dec_jobs"] = sum(w_ * c for w_, c in r["dec_widths"].items())
        require(lost > 0 and r["dec_jobs"] >= lost,
                f"cluster: the read decoded every object that lost a data "
                f"shard ({r['dec_jobs']} dec jobs, {lost} objects)")

        # 4. one striped object
        striper = RadosStriper(io_a, stripe_unit=s_unit,
                               stripe_count=s_count, object_size=s_obj)
        row = s_unit * s_count
        off = 3 * s_unit + 12345 % s_unit
        length = row + 7

        def stripe():
            t0 = time.perf_counter()
            striper.write("striped", big)
            wall_w = time.perf_counter() - t0
            t0 = time.perf_counter()
            whole = b"".join(striper.read("striped", row, at)
                             for at in range(0, s_bytes, row))
            wall_r = time.perf_counter() - t0
            part = striper.read("striped", length, off)
            require(whole == big, "cluster: the striped object read back "
                                  "whole")
            require(part == big[off:off + length],
                    f"cluster: the striped object read back at offset "
                    f"{off}, {length} bytes")
            return {"write_s": wall_w, "read_s": wall_r,
                    "objects": len(striper.component_oids("striped",
                                                          s_bytes))}

        sp = step("stripe", stripe)
        sp["write_gbs"] = s_bytes / sp["write_s"] / 1e9
        sp["read_gbs"] = s_bytes / sp["read_s"] / 1e9
        comps = {}
        for objno, o, units in striper._extents(0, s_bytes):
            comps.setdefault(objno, bytearray(s_obj))[
                o:o + sum(u[2] for u in units)] = b"".join(
                big[lpos:lpos + n] for _, lpos, n in units)
        sp["ec_shards_checked"] = sum(
            ec_shards_checked(ds, A, striper._obj_name("striped", objno),
                              np.frombuffer(bytes(data), np.uint8), plain,
                              si)
            for objno, data in sorted(comps.items()))
        res["edges"] = sum(len(v) for v in lockdep.edge_graph().values())
    finally:
        if rc is not None:
            rc.shutdown()
        ds.shutdown()
        lockdep.enable(was)

    # 5. nothing the client or the daemons started is left
    no_threads_left(before_threads, "cluster")
    return res


def phase_cluster(torch, dev, log) -> dict:
    """The ``cluster`` phase: ``run_cluster`` at full width, the port's
    ``RadosClient`` over twelve port OSD daemons (isa k=8 m=4 over all
    twelve, a replicated pool of size 3) on one map.  A ``_calc_target``
    must be one K6 launch; the write must launch K1, the CRC kernel and
    K6 (the objecter's placement); the failover K6; the degraded read K1
    and K6; the striped object K1 and K6 (a ``WRITE`` is encoded by the
    queue's ``enc`` kind with ``hinfo`` from the host CRC; only an
    all-``WRITEFULL`` op rides the ``encp`` batch and the CRC kernel)."""
    res = run_cluster(torch, dev)
    st = res["steps"]
    require(res["k6_per_target"] == 1,
            f"cluster: one _calc_target is one K6 launch "
            f"({res['k6_per_target']})")
    for name, need in (("write", ("gf256_matmul", "crc32c_rows",
                                  "crush_rule")),
                       ("failover", ("gf256_matmul", "crc32c_rows",
                                     "crush_rule")),
                       ("read", ("gf256_matmul", "crush_rule")),
                       ("stripe", ("gf256_matmul", "crush_rule"))):
        require(all(st[name]["counts"][x] > 0 for x in need)
                and st[name]["objecter_k6"] > 0,
                f"cluster: the {name} step ran {list(need)} and the "
                f"objecter's placement: {st[name]['counts']}, "
                f"{st[name]['objecter_k6']} targets")
    lines = {}
    for name, s in st.items():
        lines[name] = {
            "wall_s": round(s["wall_s"], 3),
            **({"gbs": round(s["gbs"], 4)} if "gbs" in s else {}),
            "resends": s["resends"], "resent_ops": s["resent_ops"],
            "op_s": s["op_s"],
            "objecter_k6": s["objecter_k6"],
            "encp_widths": s["encp_widths"], "dec_widths": s["dec_widths"],
            "launches": {x: v for x, v in s["counts"].items() if v}}
    w, fo, r, sp = st["write"], st["failover"], st["read"], st["stripe"]
    log(f"cluster: RadosClient(client.{CLUSTER_CLIENT}) over "
        f"{DAEMON_OSDS} OSDService (isa k=8 m=4 pool, size 12, "
        f"{DAEMON_PG_NUM} PGs; replicated pool, size 3, {DAEMON_PG_NUM} "
        f"PGs) under lockdep: {CLUSTER_OBJS} x 4 MiB IoCtx.aio_operate "
        f"WRITEFULL from 8 threads {w['gbs']:.3f} GB/s "
        f"({w['wall_a_s']:.3f} s, {w['ec_shards_checked']} shards equal "
        f"to the plain encode, hinfo the host CRC), {DAEMON_REP_OBJS} x "
        f"64 KiB {w['wall_b_s']:.3f} s; failover: {fo['objects']} writes "
        f"in flight to osd.{res['down']}'s PGs, it shut down and the map "
        f"refreshed, all answered 0 in {fo['wall_s']:.3f} s "
        f"({fo['resent_ops']} resent, one log entry a reqid); degraded "
        f"IoCtx.read, {CLUSTER_READ_THREADS} at a time, {r['gbs']:.3f} "
        f"GB/s ({r['wall_a_s']:.3f} s, "
        f"{r['dec_jobs']} dec jobs, {r['lost_data_objects']} objects lost "
        f"a data shard); RadosStriper {CLUSTER_STRIPED[0] >> 20} MiB "
        f"(su {CLUSTER_STRIPED[1] >> 20} MiB x {CLUSTER_STRIPED[2]}, "
        f"{CLUSTER_STRIPED[3] >> 20} MiB objects, {sp['objects']} objects) "
        f"write {sp['write_gbs']:.3f} GB/s, read {sp['read_gbs']:.3f} "
        f"GB/s (a stripe of units a call), whole and at an unaligned "
        f"offset; per step "
        f"{json.dumps(lines)}; refreshes {json.dumps(res['refresh'])}; "
        f"{res['edges']} lock-order edges; no thread left")
    return res


VSTART_MONS = 3              # a quorum of three port Monitors
VSTART_OBJS = 8              # 4 MiB objects (RADOS's default object size),
#                              cut from 16: at 16 the script took 731.3 s
#                              to the kernel line on an NVIDIA H100 80GB
#                              HBM3 at 700 W, above its 673 s budget
VSTART_PG_NUM = 8            # the EC pool's PGs (VStartCluster's default)
VSTART_THREADS = 8           # concurrent writers, as the cluster phase's
VSTART_WAIT_S = 60.0         # each wait of the phase (elections, boots)
MGR_BENCH_S = 3.0            # the mgr step's rados bench: write seconds,
MGR_SEQ_S = 2.0              # then seq seconds, from
MGR_BENCH_THREADS = 2        # two threads at one stripe an object
MGR_CEPH_LINES = ("status", "health", "osd tree", "osd df", "mgr status",
                  "ops latency")  # run through the port's ceph dispatch
# the kernels of the phase's write and read, whose first launches in the
# phase must all be its daemons' warmups (gpu/devwatch.py)
WATCHED = ("gf256_matmul", "crc32c_rows", "crush_rule")


class _VStartShards:
    """What ``ec_shards_checked`` reads of a ``DaemonSet``, over a
    ``VStartCluster``: the map a mon committed and the daemons."""

    def __init__(self, c, osdmap) -> None:
        self.osdmap, self.osds, self.what = osdmap, c.osds, "vstart"


def http_get(port: int, path: str) -> tuple:
    """GET ``path`` of the dashboard on 127.0.0.1:``port``: (status,
    content type, body text); an error status or no answer raises."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=VSTART_WAIT_S) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def captured(fn, argv) -> tuple:
    """``fn(argv)``'s return code and what it printed (a tool's ``main``)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def run_vstart(torch, dev, *, n_mons: int = VSTART_MONS,
               n_osds: int = DAEMON_OSDS, profile: str = WIRE_PROFILE,
               nobj: int = VSTART_OBJS, obj_bytes: int = 4 * MiB,
               stripe_bytes: int = 1 * MiB, threads: int = VSTART_THREADS,
               pg_num: int = VSTART_PG_NUM) -> dict:
    """A cluster as ``vstart`` starts one (``ceph_tpu_torch/vstart.py``),
    under lockdep: ``n_mons`` port ``Monitor``s on ``LSMStore``s and
    ``n_osds`` port ``OSDService``s on BlockStores under a temporary
    ``data_dir``, ``warmup=True``, every mon, daemon and client on
    ``dev``.  Its steps, each timed, with the launch counts zeroed before
    and read after:

    1. ``boot``: ``VStartCluster(..., wait=False)`` starts the mons
       and every daemon's ``init`` (its boot warmup, which waits for a
       pool's codec) and ``MOSDBoot`` (``start_s``); then the mons'
       leader (rank 0 by deference) is seen (``quorum_s``, from the
       start), and every daemon up in the leader's map, each boot a
       committed map epoch (``boot_s``, from the quorum);
       ``pool``: ``osd erasure-code-profile set`` (``profile`` with a
       ``stripe_bytes`` stripe) and ``osd pool create`` through the
       mons, each daemon's maps caught up and its warmup resumed with the
       pool's codec (K1, the CRC kernel, K6), then every daemon's PGs
       settled (``settle_s``); every first launch of ``WATCHED`` in the
       phase so far (the device watch's compile table,
       ``gpu/devwatch.py``) is classed ``warmup``, and none is rogue;
    2. ``write`` and ``read`` (below) run inside the watch's
       ``steady_state()``, which must record no first launch;
       ``write``: ``nobj`` seeded objects of ``obj_bytes`` written by
       ``IoCtx.operate`` ``WRITEFULL`` of the port's ``RadosClient``
       (``c.client()``) from ``threads`` threads, every reply 0: the objecter's
       ``_calc_target`` (K6) and the primary's ``encp`` batch (K1 and
       the CRC kernel); every stored shard equal to the plain encode
       with its ``hinfo`` the host CRC of it; then ``relay``: ``pg
       deep-scrub`` of object 0's PG through the mons, whose leader walks
       the PG's primary (``pg_to_up_acting``, K6) and relays an
       ``MPGCommand`` to it, until that PG's deep-scrub stamp moves;
       ``mgr``: ``c.start_mgr(dashboard=True)``; the dashboard's
       ``/api/status`` (every daemon up), ``/api/pgs`` (every PG of the
       pool, once the leader's PGMap has them), ``/api/perf`` and
       ``/metrics`` (a ``# TYPE`` line, a daemon's ``op_w`` counter
       above 0, a final newline) over HTTP; the port's ``ObjBencher`` on
       the pool, ``write`` for ``MGR_BENCH_S`` seconds from
       ``MGR_BENCH_THREADS`` threads at one stripe (``stripe_bytes``) an
       object, ``seq`` for ``MGR_SEQ_S``, ``cleanup``, no error (K6, K1 and
       the CRC kernel); then ``MGR_CEPH_LINES`` through the port's
       ``ceph`` dispatch, ``ops latency`` counting at least the bench's
       ops more than before it; ``/metrics`` carries
       ``ceph_xla_compile_total`` of each of ``WATCHED`` (at least 1) and
       ``ceph_xla_exec_us`` histograms whose ``le="+Inf"`` bucket is their
       ``_count``, and ``ceph daemon osd.0 device compile dump`` answers
       the mgr's table;
    3. ``leader_loss``: the leader mon shut down; the two left elect a
       new leader, a ``config set`` commits through it and reaches every
       live mon, and ``nobj // 4`` more objects are written;
    4. ``osd_loss``: the daemon holding data shard 1 of object 0's PG
       (not its primary) shut down; the mons mark it down from the
       others' failure reports, the client's map follows;
       ``mgr_health``: the dashboard's ``/api/health`` (through the
       mons) and its ``/metrics`` health gauges (the mgr's feed, from the
       leader of the moment) both name the victim's ``OSD_DOWN``;
       ``read``: every
       object read back by ``IoCtx.operate`` ``READ``, one at a time
       (as the cluster phase reads), byte for byte,
       ``dec`` jobs (K1) for the objects that lost a data shard;
       ``objectstore_tool``: the port's tool, offline on the lost
       daemon's BlockStore (its ``shutdown`` unmounted it): ``list-pgs``
       names object 0's PG, and in that PG's ``export`` object 0's shard
       1 equals the plain encode's and every seeded object's ``hinfo``
       is the host CRC of its exported bytes; ``monstore_tool``: the port's
       ``show-paxos`` on the killed mon's store directory, offline;
    5. ``mon_restart``: the killed mon restarts from its ``LSMStore``
       directory on its old port and rejoins (rank 0 leads again); its
       ``last_committed`` and every other mon's reach the leader's, at
       least the version committed before the restart, and every mon's
       map the leader's epoch, at least the epoch before the restart;
       the version it loaded is the ``last_committed`` that
       ``monstore_tool`` read;
    6. the cluster shut down and no thread it started left (the
       process's queue worker and fan-out executor aside); the watch
       raised no recompile storm in the phase, and the cluster log
       carries no ``RECOMPILE_STORM``.

    Returns the walls, counts and checks; raises on any failed check."""
    import os
    import tempfile

    from ceph_tpu_torch.core import lockdep
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import default_queue
    from ceph_tpu_torch.core.crc import crc32c
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd import backend as ob
    from ceph_tpu_torch.osd.ecutil import StripeInfo
    from ceph_tpu_torch.osd.types import (OP_READ, OP_WRITEFULL, OSDOp,
                                          pgid_str)
    from ceph_tpu_torch.store.lsm import LSMStore
    from ceph_tpu_torch.vstart import VStartCluster

    unit = codec_from_profile(profile, device=dev).get_chunk_size(
        stripe_bytes)
    ec_profile = f"{profile} stripe_unit={unit}"
    plain = codec_from_profile(ec_profile, device="cpu")
    k, m = plain.k, plain.m
    require(k + m == n_osds, f"vstart: one daemon a shard "
                             f"({k + m} != {n_osds})")
    si = StripeInfo(k, unit)
    extra = max(1, nobj // 4)
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    objs = torch.randint(0, 256, (nobj + extra, obj_bytes),
                         dtype=torch.uint8, device=dev,
                         generator=g).cpu().numpy()
    oids = [f"rbd_data.{i:016x}" for i in range(nobj + extra)]
    tmp = tempfile.TemporaryDirectory(prefix="vstart-")
    tools_dir = tempfile.TemporaryDirectory(prefix="vstart-tools-")
    before_threads = {t.ident for t in threading.enumerate()}
    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    res: dict = {"steps": {}}
    dq = default_queue(dev)
    watch = ObjecterWatch()
    from ceph_tpu_torch.gpu import devwatch

    dw = devwatch.watch()
    # the compile table before the phase: what the phase adds is its own
    seen0 = {(r["family"], r["sig"]) for r in dw.first_launches()}
    rogue0 = dw.compile_totals()["rogue"]
    storms0 = dw.perf.value("recompile_storms")

    def steady(fn):
        """``fn()`` inside the watch's steady-state section: its result
        and the first launches the guard recorded there."""
        g0 = len(devwatch.GUARD_VIOLATIONS)
        with dw.steady_state():
            out = fn()
        return out, devwatch.GUARD_VIOLATIONS[g0:]
    c = None            # the cluster
    dead = [None]       # the mon shut down in the leader_loss step

    def step(name: str, fn) -> dict:
        watch.reset()
        dec0 = sum(w_ * n_ for w_, n_ in dq.dec_batch_jobs.items())
        out = run_step(res, name, fn)
        out.update(watch.read())
        out["dec_jobs"] = sum(w_ * n_ for w_, n_ in
                              dq.dec_batch_jobs.items()) - dec0
        return out

    def live_leader():
        lead = [mo for mo in c.mons if mo is not dead[0]
                and mo.state == "leader"]
        return lead[0] if len(lead) == 1 else None

    def wait(pred, what: str) -> float:
        t0 = time.perf_counter()
        c.wait_for(pred, VSTART_WAIT_S, what)
        return time.perf_counter() - t0

    try:
        # 1. quorum and boot, then the pool through the mons
        def boot():
            nonlocal c
            t0 = time.perf_counter()
            c = VStartCluster(n_mons=n_mons, n_osds=n_osds,
                              data_dir=tmp.name, store_kind="blockstore",
                              warmup=True, wait=False, device=dev)
            start_s = time.perf_counter() - t0
            quorum_s = start_s + wait(lambda: live_leader() is not None,
                                      "mon quorum")
            boot_s = wait(lambda: int(
                live_leader().osdmap.osd_state_up.sum()) == n_osds,
                "every daemon up in the leader's map")
            lead = live_leader()
            return {"start_s": start_s, "quorum_s": quorum_s,
                    "boot_s": boot_s,
                    "leader": lead.rank,
                    "election_epoch": lead.election_epoch,
                    "epoch": lead.osdmap.epoch,
                    "last_committed": lead.last_committed,
                    "warmup_s": [round(o._warmup.stats()["seconds"], 3)
                                 for o in c.osds.values()]}

        step("boot", boot)
        pool_box: dict = {}

        def make_pool():
            pool_box["id"] = c.create_pool(
                "ecpool", pool_type="erasure", ec_profile=ec_profile,
                pg_num=pg_num)
            created = time.perf_counter()
            # the writes start once every PG is active, as a user waits
            # for the pool's PGs before loading it
            for o in c.osds.values():
                require(o.wait_pgs_settled(WIRE_WAIT_S),
                        f"vstart: osd.{o.whoami}'s PGs settled after the "
                        "pool create")
            return {"pool": pool_box["id"],
                    "epoch": live_leader().osdmap.epoch,
                    "settle_s": time.perf_counter() - created}

        step("pool", make_pool)
        A = pool_box["id"]
        new = [r for r in dw.first_launches()
               if (r["family"], r["sig"]) not in seen0]
        cold = [r for r in new
                if r["family"] in WATCHED and r["class"] != "warmup"]
        require(not cold, f"vstart: every first launch of {WATCHED} up to "
                          f"the pool is its daemons' warmup: {cold}")
        require(dw.compile_totals()["rogue"] == rogue0,
                f"vstart: no rogue first launch up to the pool: {new}")
        res["watch"] = {"pool_first_launches": new, "build": dw.build(),
                        "warmup": dw.warmup_stats}
        rc = c.client()
        watch.attach(rc.objecter)
        io_ = rc.ioctx(A)

        def pg_view(oid: str) -> dict:
            """Each live holder's view of ``oid``'s PG (for a failure)."""
            om = live_leader().osdmap
            pgid = om.object_to_pg(A, oid)
            return {o.whoami: (o.pgs[pgid].state, str(
                o.pgs[pgid].info.last_update), o.pgs[pgid].primary)
                for o in c.osds.values() if o.up and pgid in o.pgs}

        def put(i: int) -> None:
            op = io_.aio_operate(oids[i], [OSDOp(OP_WRITEFULL,
                                                 data=memoryview(objs[i]))],
                                 timeout=WIRE_WAIT_S)
            rep = op.result(WIRE_WAIT_S)
            require(rep.result == 0,
                    f"vstart: the write of {oids[i]} answered {rep.result} "
                    f"after {op.attempts} sends (holders' state, "
                    f"last_update, primary: {pg_view(oids[i])})")

        # 2. write (steady), then the leader's relay of a deep scrub
        def writes():
            wall, guard = steady(lambda: run_threads(put, nobj, threads))
            return {"wall_a_s": wall, "guard": guard}

        w = step("write", writes)
        require(not w["guard"], f"vstart: the write launched at no new "
                                f"signature (steady-state guard): "
                                f"{w['guard']}")
        w["gbs"] = nobj * obj_bytes / w["wall_a_s"] / 1e9
        osdmap = live_leader().osdmap
        shards = _VStartShards(c, osdmap)
        w["ec_shards_checked"] = sum(
            ec_shards_checked(shards, A, oids[i], objs[i], plain, si)
            for i in range(nobj))
        pg0 = osdmap.object_to_pg(A, oids[0])
        _u, _up, acting0, prim0 = osdmap.pg_to_up_acting(pg0)

        def stamp() -> float:
            return next(r_["last_deep_scrub"]
                        for r_ in c.osds[prim0].dump_scrubs()["scrubs"]
                        if r_["pgid"] == pgid_str(pg0))

        def relay():
            s0 = stamp()
            k6 = read_counts()["crush_rule"]
            code, out = c.command({"prefix": "pg deep-scrub",
                                   "pgid": pgid_str(pg0)})
            k6 = read_counts()["crush_rule"] - k6
            require(code == 0 and out.get("instructed") == f"osd.{prim0}",
                    f"vstart: pg deep-scrub relayed to osd.{prim0}: "
                    f"{code} {out}")
            wait(lambda: stamp() > s0, f"the deep scrub of pg "
                 f"{pgid_str(pg0)}")
            return {"pgid": pgid_str(pg0), "primary": prim0,
                    "command_k6": k6}

        step("relay", relay)

        # the mgr over the cluster: its dashboard over HTTP, a bench on
        # the pool, the admin CLI's commands
        from ceph_tpu_torch.tools import ceph as ceph_cli
        from ceph_tpu_torch.tools import monstore_tool, objectstore_tool
        from ceph_tpu_torch.tools.rados_bench import ObjBencher

        def ceph(line: str) -> dict:
            code, out, _text = ceph_cli.dispatch(c, line.split())
            require(code == 0, f"vstart: ceph {line}: {code} {out}")
            return out

        def mgr():
            t0 = time.perf_counter()
            port = c.start_mgr(dashboard=True).modules["dashboard"].port
            start_s = time.perf_counter() - t0
            _code, ctype, body = http_get(port, "/api/status")
            status = json.loads(body)
            require(ctype.startswith("application/json")
                    and status.get("num_up_osds") == n_osds,
                    f"vstart: the dashboard's /api/status: {status}")
            want = {f"{A}.{ps}" for ps in range(pg_num)}
            pgs_s = wait(lambda: want <= {
                r_["pgid"] for r_ in live_leader().pgmap.pg_rows()},
                "every PG of the pool in the leader's PGMap")
            pgs = json.loads(http_get(port, "/api/pgs")[2])
            require(want <= {r_["pgid"] for r_ in pgs["pg_stats"]},
                    f"vstart: the dashboard's /api/pgs has the pool's "
                    f"{pg_num} PGs: {pgs['by_state']}")
            perf = json.loads(http_get(port, "/api/perf")[2])
            require(any(sub.endswith(".op") for subs in perf.values()
                        for sub in subs),
                    f"vstart: the dashboard's /api/perf: {sorted(perf)}")
            lat0 = ceph("ops latency").get("lat_op_us", {}).get("count", 0)
            bench = ObjBencher(io_)
            t0 = time.perf_counter()
            wr = bench.write(MGR_BENCH_S, MGR_BENCH_THREADS, stripe_bytes)
            sq = bench.seq(MGR_SEQ_S, MGR_BENCH_THREADS)
            bench.cleanup()
            bench_wall = time.perf_counter() - t0
            require(wr["errors"] == 0 and sq["errors"] == 0
                    and wr["total_ops"] > 0 and sq["total_ops"] > 0,
                    f"vstart: the mgr step's bench: {wr} {sq}")
            answers = {line: ceph(line) for line in MGR_CEPH_LINES}
            lat = answers["ops latency"]["lat_op_us"]
            require(lat["count"] - lat0 >= wr["total_ops"] + sq["total_ops"],
                    f"vstart: ops latency counted the bench's ops ({lat0} "
                    f"-> {lat['count']}; {wr['total_ops']} writes, "
                    f"{sq['total_ops']} reads)")
            _code, _ctype, metrics = http_get(port, "/metrics")
            require(metrics.endswith("\n") and "# TYPE " in metrics
                    and re.search(r'^ceph_osd_\d+_op_w\{daemon="[^"]+"\} '
                                  r'[1-9]', metrics, re.M),
                    "vstart: /metrics has TYPE lines, a daemon's op_w "
                    "counter and a final newline")
            xla = {f: int(v) for f, v in re.findall(
                r'^ceph_xla_compile_total\{family="([^"]+)"\} (\d+)$',
                metrics, re.M)}
            require(all(xla.get(f, 0) >= 1 for f in WATCHED),
                    f"vstart: /metrics has ceph_xla_compile_total of "
                    f"{WATCHED}: {xla}")
            inf = dict(re.findall(r'^ceph_xla_exec_us_bucket\{family="'
                                  r'([^"]+)",le="\+Inf"\} (\S+)$',
                                  metrics, re.M))
            cnt = dict(re.findall(r'^ceph_xla_exec_us_count\{family="'
                                  r'([^"]+)"\} (\S+)$', metrics, re.M))
            require(inf and inf == cnt,
                    f"vstart: each ceph_xla_exec_us histogram's +Inf "
                    f"bucket is its count: {inf} {cnt}")
            code, table, _text = ceph_cli.dispatch(
                c, ["daemon", "osd.0", "device", "compile", "dump"])
            mgr_table = ceph("device compile dump")
            require(code == 0 and {
                f: x["compiles"] for f, x in table["families"].items()} == {
                f: x["compiles"] for f, x in mgr_table["families"].items()},
                "vstart: ceph daemon osd.0 device compile dump answers the "
                "mgr's compile table")
            return {"start_s": start_s, "pgs_s": pgs_s,
                    "bench_wall_s": bench_wall,
                    "bench": {op["op"]: {key: op[key] for key in (
                        "total_ops", "mb_per_sec", "avg_latency_s",
                        "max_latency_s", "errors")} for op in (wr, sq)},
                    "ops_counted": lat["count"] - lat0,
                    "lat_op_us": lat, "health": answers["health"]["status"],
                    "tree_nodes": len(answers["osd tree"]["nodes"]),
                    "mgr_daemons": answers["mgr status"]["daemons"],
                    "metrics_lines": metrics.count("\n"),
                    "xla_compiles": {f: xla[f] for f in WATCHED}}

        step("mgr", mgr)

        # 3. the leader lost: a new one elected, a config set through
        # it, and the writes go on
        def leader_loss():
            old = live_leader()
            dead[0] = old
            t0 = time.perf_counter()
            old.shutdown()
            elect_s = wait(lambda: live_leader() is not None,
                           "a new leader of the mons left")
            new = live_leader()
            code, out = c.command({"prefix": "config set", "who": "global",
                                   "name": "vstart_phase", "value": "on"})
            require(code == 0, f"vstart: config set through mon."
                               f"{new.rank}: {code} {out}")
            wait(lambda: all(
                mo.services["config"].db.get("global", {}).get(
                    "vstart_phase") == "on"
                for mo in c.mons if mo is not old),
                "the config set on every live mon")
            commit_s = time.perf_counter() - t0 - elect_s
            wall = run_threads(lambda i: put(nobj + i), extra, threads)
            return {"killed": old.rank, "leader": new.rank,
                    "election_epoch": new.election_epoch,
                    "elect_s": elect_s, "config_commit_s": commit_s,
                    "objects": extra, "wall_a_s": wall}

        ll = step("leader_loss", leader_loss)
        res["killed_mon"] = ll["killed"]

        # 4. an OSD lost: marked down by failure reports, every object
        # read back degraded
        victim = acting0[1]
        require(victim != prim0 and victim != ob.CRUSH_ITEM_NONE,
                f"vstart: data shard 1 of {oids[0]} on a daemon that is "
                f"not its primary ({acting0})")

        def osd_loss():
            c.kill_osd(victim)
            down_s = wait(lambda: not live_leader().osdmap.is_up(victim),
                          f"osd.{victim} marked down")
            client_s = wait(lambda: not rc.objecter.osdmap.is_up(victim),
                            f"the client's map with osd.{victim} down")
            return {"victim": victim, "down_s": down_s,
                    "client_map_s": client_s,
                    "epoch": live_leader().osdmap.epoch}

        step("osd_loss", osd_loss)

        def mgr_health():
            # the mon's answer through the dashboard, then the mgr's own
            # feed (its health_fn resolves the leader of the moment)
            port = c.mgr.modules["dashboard"].port
            health = json.loads(http_get(port, "/api/health")[2])
            down = health.get("checks", {}).get("OSD_DOWN", {})
            require(f"osd.{victim} is down" in down.get("detail", []),
                    f"vstart: the dashboard's /api/health names osd."
                    f"{victim}'s OSD_DOWN: {health}")
            metrics = http_get(port, "/metrics")[2]
            require('ceph_health_check{check="OSD_DOWN",' in metrics,
                    f"vstart: the mgr's health feed followed the new leader "
                    f"to osd.{victim}'s OSD_DOWN")
            return {"status": health["status"], "osd_down": down["summary"],
                    "feed_leader": c.leader().rank}

        step("mgr_health", mgr_health)
        lost_data = 0
        lmap = live_leader().osdmap
        for i in range(nobj + extra):
            acting = lmap.pg_to_up_acting(lmap.object_to_pg(A, oids[i]))[2]
            lost_data += any(acting[s] == ob.CRUSH_ITEM_NONE
                             for s in range(k))

        def reads():
            t0 = time.perf_counter()
            for i in range(nobj + extra):
                rep = io_.operate(oids[i], [OSDOp(OP_READ)],
                                  timeout=WIRE_WAIT_S)
                got = rep.ops[0].out_data if rep.result == 0 else b""
                require(got == objs[i].tobytes(),
                        f"vstart: {oids[i]} read back byte for byte "
                        f"({rep.result}, {len(got)} bytes)")
            return time.perf_counter() - t0

        def steady_reads():
            wall, guard = steady(reads)
            return {"wall_a_s": wall, "lost_data_objects": lost_data,
                    "guard": guard}

        r = step("read", steady_reads)
        require(not r["guard"], f"vstart: the degraded read launched at no "
                                f"new signature (steady-state guard): "
                                f"{r['guard']}")
        r["gbs"] = (nobj + extra) * obj_bytes / r["wall_a_s"] / 1e9
        require(lost_data > 0 and r["dec_jobs"] >= lost_data,
                f"vstart: the read decoded every object that lost a data "
                f"shard ({r['dec_jobs']} dec jobs, {lost_data} objects)")

        # the offline tools on what the lost daemon and the lost mon left
        def objectstore():
            path = os.path.join(tmp.name, f"osd{victim}")
            argv = ["--data-path", path, "--type", "blockstore"]
            rc_, listed = captured(objectstore_tool.main,
                                   argv + ["--op", "list-pgs"])
            require(rc_ == 0 and pgid_str(pg0) in listed.split(),
                    f"vstart: objectstore_tool list-pgs on osd.{victim} "
                    f"names pg {pgid_str(pg0)}: {rc_} {listed!r}")
            exp = os.path.join(tools_dir.name, "pg.export")
            rc_, _out = captured(objectstore_tool.main, argv + [
                "--op", "export", "--pgid", pgid_str(pg0), "--file", exp])
            require(rc_ == 0, f"vstart: objectstore_tool export: {rc_}")
            _cname, exported = objectstore_tool.read_export(exp)
            planes = si.interleave(np.asarray(objs[0]))[0]
            got = [data for o, data, _x, _m in exported
                   if o.name == oids[0] and o.shard == 1]
            require(got == [planes[1].tobytes()],
                    f"vstart: object 0's shard 1 in osd.{victim}'s export "
                    f"equals the plain encode ({len(got)} found)")
            # each exported shard's hinfo is what the card's CRC kernel
            # wrote: it must be the host CRC of the exported bytes
            hinfos = 0
            for o, data, xattrs, _m in exported:
                if o.name not in oids:
                    continue
                size, hcrc, valid = ob.hinfo_decode(xattrs["hinfo"])
                require(size == obj_bytes and valid and hcrc == crc32c(data),
                        f"vstart: {o.name} shard {o.shard} in osd.{victim}'s "
                        "export: its hinfo CRC is the host CRC of the "
                        "exported bytes")
                hinfos += 1
            return {"pgs": len(listed.split()), "objects": len(exported),
                    "hinfo_checked": hinfos,
                    "export_bytes": os.path.getsize(exp)}

        step("objectstore_tool", objectstore)

        def monstore():
            rc_, shown = captured(monstore_tool.main, [
                os.path.join(tmp.name, f"mon{dead[0].rank}"), "show-paxos"])
            lc = re.search(r"^last_committed: (\d+)$", shown, re.M)
            require(rc_ == 0 and lc is not None,
                    f"vstart: monstore_tool show-paxos: {rc_} {shown!r}")
            return {"rank": dead[0].rank, "last_committed": int(lc[1])}

        ms = step("monstore_tool", monstore)

        # 5. the killed mon back from its store directory
        def mon_restart():
            rank = dead[0].rank
            before = live_leader()
            epoch0, version0 = before.osdmap.epoch, before.last_committed
            mon = Monitor(c.ctx, rank, c.monmap,
                          kv=LSMStore(os.path.join(tmp.name, f"mon{rank}")),
                          initial_map=None,
                          bind_port=c.monmap.addrs[rank][1], device=dev)
            mon.start()
            loaded = mon.last_committed
            c.mons[rank] = mon
            dead[0] = None

            def caught_up() -> bool:
                # rank 0 takes the lead back by deference, so the
                # restarted mon is held to every mon of the quorum
                lead = live_leader()
                return (lead is not None
                        and len({mo.last_committed for mo in c.mons}) == 1
                        and lead.last_committed >= version0
                        and all(mo.osdmap is not None
                                and mo.osdmap.epoch == lead.osdmap.epoch
                                for mo in c.mons)
                        and lead.osdmap.epoch >= epoch0)

            try:
                wait(caught_up, f"mon.{rank} rejoined")
            except TimeoutError:
                views = [(mo.rank, mo.state, mo.last_committed,
                          mo.osdmap.epoch if mo.osdmap is not None else None)
                         for mo in c.mons]
                require(False, f"vstart: mon.{rank} rejoined at the "
                               f"quorum's version and epoch (before: v"
                               f"{version0}, e{epoch0}; rank, state, "
                               f"version, epoch: {views})")
            lead = live_leader()
            return {"rank": rank, "loaded_version": loaded,
                    "last_committed": mon.last_committed,
                    "leader": lead.rank,
                    "leader_committed": lead.last_committed,
                    "committed": [mo.last_committed for mo in c.mons],
                    "version_before": version0, "epoch_before": epoch0,
                    "epoch": mon.osdmap.epoch, "state": mon.state}

        mr = step("mon_restart", mon_restart)
        require(mr["last_committed"] == mr["leader_committed"]
                and mr["loaded_version"] > 0,
                f"vstart: the restarted mon loaded its store and reached "
                f"the leader's version {mr}")
        require(mr["loaded_version"] == ms["last_committed"],
                f"vstart: the restarted mon loaded the version "
                f"monstore_tool read ({mr['loaded_version']} != "
                f"{ms['last_committed']})")
        res["edges"] = sum(len(v) for v in lockdep.edge_graph().values())
        res["watch"]["storms"] = dw.perf.value("recompile_storms") - storms0
        res["watch"]["phase_first_launches"] = [
            r for r in dw.first_launches()
            if (r["family"], r["sig"]) not in seen0]
        storm_lines = [ln for ln in c.ctx.log.dump_recent(10000)
                       if "RECOMPILE_STORM" in ln]
        require(res["watch"]["storms"] == 0 and not storm_lines,
                f"vstart: no recompile storm in the phase "
                f"({res['watch']['storms']}; {storm_lines[:2]})")
    finally:
        if c is not None:
            # the mon the leader_loss step shut down is not shut twice
            c.mons = [mo for mo in c.mons if mo is not dead[0]]
            c.shutdown()
        lockdep.enable(was)
        res["store_bytes"] = {
            d: sum(os.path.getsize(os.path.join(root, f))
                   for root, _dirs, files in os.walk(os.path.join(tmp.name,
                                                                  d))
                   for f in files)
            for d in sorted(os.listdir(tmp.name))}
        tmp.cleanup()
        tools_dir.cleanup()

    # 6. nothing the cluster started is left
    t0 = time.perf_counter()
    no_threads_left(before_threads, "vstart")
    res["steps"]["shutdown"] = {"threads_left": 0,
                                "wall_s": time.perf_counter() - t0}
    return res


def phase_vstart(torch, dev, log) -> dict:
    """The ``vstart`` phase: ``run_vstart`` at full width, three port
    mons on LSMStores and twelve port OSD daemons on BlockStores, one EC
    pool of ``WIRE_PROFILE`` made through the mons, ``VSTART_OBJS`` x 4
    MiB written by the port's ``RadosClient``.  The boot launches nothing (a warmup
    without a pool waits for its codec); the pool create must launch K1,
    the CRC kernel and K6 (each daemon's resumed warmup and its new PGs);
    the write K1, the CRC kernel and K6; the relay K6; the mgr step's
    bench K1, the CRC kernel and K6; the degraded read K1.  Its
    ``vstart watch:`` line is the device watch's compile table: the
    kernel build (wall, persist hit or miss), the phase's first launches
    and, for the process, every first launch of ``WATCHED`` and the build
    with its wall and class."""
    from ceph_tpu_torch.gpu import devwatch

    res = run_vstart(torch, dev)
    st = res["steps"]
    wt = res["watch"]
    table = [r for r in devwatch.watch().first_launches()
             if r["family"] in WATCHED + (devwatch.BUILD_FAMILY,)]
    warm = {k: wt["warmup"][k]
            for k in ("runs", "seconds", "buckets_warmed", "done")}
    log(f"vstart watch: build {json.dumps(wt['build'])}; warmup "
        f"{json.dumps(warm)}; "
        f"first launches up to the pool {len(wt['pool_first_launches'])}, "
        f"in the phase {json.dumps(wt['phase_first_launches'])}; guard: "
        f"write {len(st['write']['guard'])}, read {len(st['read']['guard'])} "
        f"first launches; storms {wt['storms']}; /metrics "
        f"ceph_xla_compile_total {json.dumps(st['mgr']['xla_compiles'])}; "
        f"the process's first launches {json.dumps(table)}")
    for name, need in (("pool", ("gf256_matmul", "crc32c_rows",
                                 "crush_rule")),
                       ("write", ("gf256_matmul", "crc32c_rows",
                                  "crush_rule")),
                       ("relay", ("gf256_matmul", "crush_rule")),
                       ("mgr", ("gf256_matmul", "crc32c_rows",
                                "crush_rule")),
                       ("leader_loss", ("gf256_matmul", "crc32c_rows")),
                       ("read", ("gf256_matmul", "crush_rule"))):
        require(all(st[name]["counts"][x] > 0 for x in need),
                f"vstart: the {name} step ran {list(need)}: "
                f"{st[name]['counts']}")
    require(st["write"]["objecter_k6"] > 0,
            "vstart: the client's objecter placed the writes")
    require(st["relay"]["command_k6"] > 0,
            "vstart: the leader walked the PG's primary on K6 for the relay")
    lines = {name: {key: (round(v, 4) if isinstance(v, float) else v)
                    for key, v in s.items() if key != "counts"}
             for name, s in st.items()}
    launches = {name: {x: v for x, v in s["counts"].items() if v}
                for name, s in st.items() if "counts" in s}
    w, r, mg = st["write"], st["read"], st["mgr"]
    added = sum(st[name]["wall_s"] for name in (
        "mgr", "mgr_health", "objectstore_tool", "monstore_tool"))
    log(f"vstart: {VSTART_MONS} mons on LSMStores, {DAEMON_OSDS} OSDs on "
        f"BlockStores (isa k=8 m=4 pool through the mons, size 12, "
        f"{VSTART_PG_NUM} PGs), warmup on, under lockdep: started in "
        f"{st['boot']['start_s']:.3f} s, quorum seen at "
        f"{st['boot']['quorum_s']:.3f} s, boot {st['boot']['boot_s']:.3f} "
        f"s, pool {st['pool']['wall_s']:.3f} s; {VSTART_OBJS} x 4 MiB "
        f"WRITEFULL from {VSTART_THREADS} threads {w['gbs']:.4f} GB/s "
        f"({w['wall_a_s']:.3f} s, {w['ec_shards_checked']} shards equal "
        f"to the plain encode, hinfo the host CRC); mon.{res['killed_mon']} "
        f"(the leader) lost: new leader mon.{st['leader_loss']['leader']} "
        f"in {st['leader_loss']['elect_s']:.3f} s; osd."
        f"{st['osd_loss']['victim']} lost: marked down in "
        f"{st['osd_loss']['down_s']:.3f} s; degraded read {r['gbs']:.4f} "
        f"GB/s ({r['dec_jobs']} dec jobs, {r['lost_data_objects']} objects "
        f"lost a data shard); mon.{st['mon_restart']['rank']} restarted "
        f"from its store at v{st['mon_restart']['loaded_version']}, "
        f"rejoined at v{st['mon_restart']['last_committed']} (leader "
        f"v{st['mon_restart']['leader_committed']}) in "
        f"{st['mon_restart']['wall_s']:.3f} s; mgr and dashboard: bench "
        f"{mg['bench']['write']['total_ops']} writes and "
        f"{mg['bench']['seq']['total_ops']} reads of 1 MiB from "
        f"{MGR_BENCH_THREADS} threads, 0 errors, in "
        f"{mg['bench_wall_s']:.3f} s, ops latency +{mg['ops_counted']}; "
        f"the dashboard's health named osd.{st['osd_loss']['victim']}'s "
        f"OSD_DOWN after the leader's loss; objectstore_tool and "
        f"monstore_tool offline; the mgr and tool steps {added:.3f} s; "
        f"per step "
        f"{json.dumps(lines)}; launches {json.dumps(launches)}; store "
        f"bytes {json.dumps(res['store_bytes'])}; {res['edges']} "
        f"lock-order edges; no thread left")
    return res


CLAY_PROFILE = "plugin=clay k=8 m=4 d=11"  # BASELINE.json's repair decode
CLAY_OBJS = 32               # 4 MiB objects
CLAY_PEERS = 10              # osd.1 .. osd.10; osd.1 also holds shard 11
CLAY_DOWN = 1                # the peer down for the degraded read
CLAY_PGID = (4, 0)
CLAY_FRAC_MAX = 400          # repair_read_frac, permille (d/(k*q) = 344)


def clay_acting(n: int) -> list:
    """Shard s on osd s up to ``CLAY_PEERS``, the rest from osd.1 on: the
    primary osd.0 holds shard 0 alone, osd.1 holds shards 1 and 11."""
    return [s if s <= CLAY_PEERS else 1 + (s - CLAY_PEERS - 1) % CLAY_PEERS
            for s in range(n)]


def run_clay(torch, dev, *, nobj: int = CLAY_OBJS,
             obj_bytes: int = 4 * MiB, stripe_bytes: int = 1 * MiB,
             threads: int = 8) -> dict:
    """Clay through the port's ``PG`` on the card: one PG of
    ``CLAY_PROFILE`` (clay k=8 m=4 d=11: Z = 64 sub-chunks, q = 4, t = 3)
    on a ``PGRig`` of the primary ``osd.0`` and ``CLAY_PEERS`` peers,
    shards placed by ``clay_acting``.  Steps, each with the launch counts
    zeroed before and read after (``run_step``):

    1. ``write``: ``client.4100`` sends one ``WRITEFULL`` ``MOSDOp`` an
       object from ``threads`` threads; ``pg.do_op`` stages it, and
       ``ECBackend.submit`` pads its planes to whole sub-chunks and
       encodes it with its CRCs in the queue's ``encp`` kind (the jobs
       side by side along the sub-chunk byte axis: K1 for the pair
       transforms and the MDS product, the CRC kernel over each job's
       own chunk layout).  Every stored shard must equal the plain
       encode on ``dev`` (every product through ``gf_matmul_bytes_plain``)
       and its ``hinfo`` the host CRC of it;
    2. ``repair``: the primary loses shard 0 of every object (marked in
       ``pg.missing``) and ``pg.recovery_engine().recover`` rebuilds it
       through the sub-chunk plan: one ``MECSubReadVec`` a helper a
       round with runs on every row, only the repair layers on the wire
       (``subread_bytes`` = objects x d x L x s), the queue's ``crep``
       kind; every shard and ``hinfo`` as before, ``repair_read_frac``
       at most ``CLAY_FRAC_MAX`` permille, ``missing`` empty;
    3. ``read``: ``osd.<CLAY_DOWN>`` (two shards) shuts down; one ``READ``
       ``MOSDOp`` an object through ``_ec_read_object`` ->
       ``reconstruct_async`` -> the queue's ``cdec`` kind, byte for
       byte;
    4. ``scrub``: the peer back, one deep ``scrub_engine().run`` with no
       rot is clean, its verify decodes on ``cdec``.

    Returns the steps (walls, counts, batch widths by kind), the repair
    counters and what was checked; raises on any failed check."""
    from ceph_tpu_torch.core.crc import crc32c
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.ops import gf256
    from ceph_tpu_torch.osd import backend as ob
    from ceph_tpu_torch.osd import messages as om
    from ceph_tpu_torch.osd import pg as opg
    from ceph_tpu_torch.osd.osdmap import POOL_ERASURE, PGPool
    from ceph_tpu_torch.osd.types import OP_READ, OP_WRITEFULL, OSDOp
    from ceph_tpu_torch.store.objectstore import GHObject, Transaction

    unit = codec_from_profile(CLAY_PROFILE, device=dev).get_chunk_size(
        stripe_bytes)
    profile = f"{CLAY_PROFILE} stripe_unit={unit}"
    codec = codec_from_profile(profile, device=dev)
    k, m = codec.k, codec.m
    n = k + m
    Z = codec.get_sub_chunk_count()
    acting = clay_acting(n)
    down_shards = [s for s in range(n) if acting[s] == CLAY_DOWN]
    require(acting.count(0) == 1 and len(down_shards) <= m,
            f"clay: the primary holds shard 0 alone and osd.{CLAY_DOWN} at "
            f"most m shards: {acting}")
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    objs = torch.randint(0, 256, (nobj, obj_bytes), dtype=torch.uint8,
                         device=dev, generator=g).cpu().numpy()
    oids = [f"clay_data.{i:016x}" for i in range(nobj)]
    pool = PGPool(pool_id=CLAY_PGID[0], pool_type=POOL_ERASURE, size=n,
                  erasure_code_profile=profile)
    rig = None
    res = {"steps": {}, "acting": acting, "Z": Z}
    try:
        rig = PGRig(dev, pgid=CLAY_PGID, pool=pool, codec=codec,
                    acting=acting, peers=CLAY_PEERS, threads=threads,
                    obj_bytes=obj_bytes, tag="clay")
        prim, host0, pg, q = rig.prim, rig.host0, rig.pg, rig.q
        prim.record = False  # no sub-read reply is kept
        be = pg.backend
        holders, store0 = rig.holders, rig.holders[0]
        client_d, cconn = rig.client_d, rig.cconn
        cid = pg.coll
        # the queue's clay batches, by kind and width
        batches = []
        plain_array = q._array_batch

        def array_batch(batch):
            batches.append((batch[0].kind, len(batch)))
            return plain_array(batch)

        q._array_batch = array_batch
        # the sub-chunk plan's messages, as the primary sends them
        vecs = []
        plain_send = host0.send_to_osd

        def send_to_osd(osd_id, msg):
            if isinstance(msg, om.MECSubReadVec):
                vecs.append((osd_id, [list(r) for r in msg.runs],
                             len(msg.reads)))
            plain_send(osd_id, msg)

        host0.send_to_osd = send_to_osd

        def widths(mark: int) -> dict:
            out = {}
            for kind, w in batches[mark:]:
                out.setdefault(kind, {}).setdefault(str(w), 0)
                out[kind][str(w)] += 1
            return out

        # 1. write
        def write(i):
            rep = client_d.call(cconn, i + 1, oids[i], [
                OSDOp(OP_WRITEFULL, data=memoryview(objs[i]))])
            require(rep.result == 0,
                    f"clay: the write of object {i} answered {rep.result}")

        def do_write():
            mark = len(batches)
            wall = run_threads(write, nobj, threads)
            deadline = time.monotonic() + WIRE_WAIT_S
            while ((pg._oid_pipes or be.in_flight)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            return {"wall": wall, "batches": widths(mark)}

        run_step(res, "write", do_write)
        require(not prim.failed, f"clay: do_op raised {prim.failed}")
        staged = pg.stage_snapshot()
        require(staged == {"staged": nobj, "degraded": 0},
                f"clay: every write staged, none degraded: {staged}")
        # every stored shard against the plain encode on ``dev``
        real = gf256.gf_matmul_bytes

        def plain_product(matrix, x, donate=False, seed=0, out=None,
                          mul_shift=False):
            got = gf256.gf_matmul_bytes_plain(matrix, x, seed)
            return got if out is None else out.copy_(got)

        t_check = time.perf_counter()
        checked = 0
        gf256.gf_matmul_bytes = plain_product
        try:
            for i in range(nobj):
                planes = be._prep_planes(objs[i].tobytes())
                coding = codec.encode_array(planes)
                for num, st in holders.items():
                    for s in (s for s in range(n) if acting[s] == num):
                        go = GHObject(oids[i], shard=s)
                        got = st.read(cid, go)
                        want = planes[s] if s < k else coding[s - k]
                        size, hcrc, valid = ob.hinfo_decode(
                            st.getattr(cid, go, "hinfo"))
                        require(got == want.tobytes(),
                                f"clay: osd.{num} object {i} shard {s} "
                                "equals the plain encode")
                        require(valid and size == obj_bytes
                                and hcrc == crc32c(got),
                                f"clay: osd.{num} object {i} shard {s}: "
                                "hinfo CRC is the host CRC")
                        checked += 1
        finally:
            gf256.gf_matmul_bytes = real
        res["check_s"] = time.perf_counter() - t_check
        res["checked"] = checked
        width = len(store0.read(cid, GHObject(oids[0], shard=0)))
        require(width % Z == 0, f"clay: chunk width {width} in sub-chunks")

        # 2. the primary's shard 0 of every object, repaired
        before = {oid: (bytes(store0.read(cid, GHObject(oid, shard=0))),
                        store0.getattr(cid, GHObject(oid, shard=0),
                                       "hinfo")) for oid in oids}
        t = Transaction()
        for oid in oids:
            t.remove(cid, GHObject(oid, shard=0))
        store0.queue_transaction(t)
        with pg.lock:
            for oid in oids:
                pg.missing[oid] = pg.log.latest_for(oid).version
            work = {oid: pg.log.latest_for(oid) for oid in oids}
        perf = host0.pg_perf
        sub0 = perf.value("subread_bytes")
        window = int(host0.ctx.conf.get("osd_recovery_max_active"))

        def do_repair():
            mark, v0 = len(batches), len(vecs)
            wall_t0 = time.monotonic()
            pg.recovery_engine().recover(work)
            wall = time.monotonic() - wall_t0
            deadline = time.monotonic() + WIRE_WAIT_S
            while (sum(w for kd, w in batches[mark:] if kd == "crep")
                   < nobj and time.monotonic() < deadline):
                time.sleep(0.001)
            return {"wall": wall, "batches": widths(mark),
                    "vecs": vecs[v0:]}

        rep_step = run_step(res, "repair", do_repair)
        rvecs = rep_step.pop("vecs")
        with pg.lock:
            missing, unfound = dict(pg.missing), set(pg.unfound)
        require(not missing and not unfound,
                f"clay: missing {sorted(missing)[:4]} unfound "
                f"{sorted(unfound)[:4]} after the repair")
        for oid, (data, hinfo) in before.items():
            go = GHObject(oid, shard=0)
            require(bytes(store0.read(cid, go)) == data
                    and store0.getattr(cid, go, "hinfo") == hinfo,
                    f"clay: {oid} shard 0 and its hinfo as before the loss")
        L = len(codec.repair_layers(0))
        s_sub = width // Z
        frac = perf.value("repair_read_frac")
        rounds = -(-nobj // window)
        sub_bytes = perf.value("subread_bytes") - sub0
        require(rvecs and all(all(r for r in runs) and len(runs) == nr
                              for _o, runs, nr in rvecs),
                f"clay: every MECSubReadVec row carried runs "
                f"({len(rvecs)} messages)")
        require(len(rvecs) <= CLAY_PEERS * rounds,
                f"clay: {len(rvecs)} MECSubReadVec, at most one a helper "
                f"a round ({CLAY_PEERS} x {rounds})")
        require(sub_bytes == nobj * codec.d * L * s_sub,
                f"clay: only the repair layers on the wire: {sub_bytes} "
                f"== {nobj} x {codec.d} x {L} x {s_sub}")
        require(0 < frac <= CLAY_FRAC_MAX,
                f"clay: repair_read_frac {frac} permille <= "
                f"{CLAY_FRAC_MAX}")
        require("crep" in rep_step["batches"],
                f"clay: the repair rode crep {rep_step['batches']}")
        res["repair"] = {"frac_permille": frac, "subread_bytes": sub_bytes,
                         "vecs": len(rvecs), "rounds": rounds,
                         "window": window, "L": L, "s": s_sub}

        # 3. degraded read with osd.<CLAY_DOWN> (two shards) down
        rig.peer_m[CLAY_DOWN].shutdown()
        rig.osdmap.down.add(CLAY_DOWN)
        pg.note_peers_down({CLAY_DOWN})
        with pg.lock:
            pg.state = opg.STATE_DEGRADED
        pg._obc_invalidate()
        decoded = [None] * nobj

        def read(i):
            rep = client_d.call(cconn, nobj + i + 1, oids[i],
                                [OSDOp(OP_READ)])
            require(rep.result == 0,
                    f"clay: the read of object {i} answered {rep.result}")
            decoded[i] = bytes(rep.ops[0].out_data)

        def do_read():
            mark = len(batches)
            wall = run_threads(read, nobj, threads)
            return {"wall": wall, "batches": widths(mark)}

        rd = run_step(res, "read", do_read)
        require(not prim.failed, f"clay: do_op raised {prim.failed}")
        require(all(decoded[i] == objs[i].tobytes() for i in range(nobj)),
                "clay: every degraded read returns what was written")
        require(sum(rd["batches"].get("cdec", {}).values()) > 0,
                f"clay: the degraded reads rode cdec {rd['batches']}")
        res["down_shards"] = down_shards

        # 4. the peer back; one deep scrub, no rot
        pm = rig.start_peer(CLAY_DOWN)
        host0.connect(CLAY_DOWN, rig.primary.connect(pm.addr), pm.addr)
        rig.osdmap.down.discard(CLAY_DOWN)
        with pg.lock:
            pg.state = opg.STATE_ACTIVE
        eng = pg.scrub_engine()

        def do_scrub():
            mark = len(batches)
            errs = eng.run(deep=True)
            return {"errors": len(errs), "batches": widths(mark)}

        sc = run_step(res, "scrub", do_scrub)
        require(sc["errors"] == 0, "clay: the deep scrub is clean")
        require(sum(sc["batches"].get("cdec", {}).values()) > 0,
                f"clay: the scrub's verify decodes rode cdec "
                f"{sc['batches']}")
        res["ragged_products"] = codec.ragged_products
        res["pair_products"] = codec.pair_products
        res["products"] = codec.products
    finally:
        if rig is not None:
            rig.close()
    return res


def phase_clay(torch, dev, log) -> dict:
    """The ``clay`` phase: ``run_clay`` at full width, 32 x 4 MiB objects
    of clay k=8 m=4 d=11 through one PG over the primary and ten peers.
    The write must launch K1 and the CRC kernel, the repair, the read and
    the scrub K1."""
    t0 = time.monotonic()
    res = run_clay(torch, dev)
    st = res["steps"]
    require(all(st[s]["counts"]["gf256_matmul"] > 0
                for s in ("write", "repair", "read", "scrub"))
            and st["write"]["counts"]["crc32c_rows"] > 0,
            f"clay: K1 in every step, the CRC kernel in the write "
            f"{ {s: st[s]['counts'] for s in st} }")
    walls = {s: round(st[s]["wall_s"], 3) for s in st}
    launches = {s: {kk: v for kk, v in st[s]["counts"].items() if v}
                for s in st}
    widths = {s: st[s]["batches"] for s in st}
    log(f"clay: {CLAY_PROFILE} (Z={res['Z']}), {CLAY_OBJS} x 4 MiB through "
        f"PG.do_op over osd.0 and {CLAY_PEERS} peers (acting "
        f"{res['acting']}): walls {json.dumps(walls)}; batch widths by "
        f"kind {json.dumps(widths)}; launches {json.dumps(launches)}; "
        f"repair_read_frac {res['repair']['frac_permille']} permille "
        f"(subread_bytes {res['repair']['subread_bytes']}, "
        f"{res['repair']['vecs']} MECSubReadVec in "
        f"{res['repair']['rounds']} rounds, L={res['repair']['L']}, "
        f"s={res['repair']['s']}); degraded read with shards "
        f"{res['down_shards']} down; deep scrub clean; {res['checked']} "
        f"shards equal the plain encode (check {res['check_s']:.3f} s); "
        f"clay products {res['products']} (1x2 pair transforms "
        f"{res['pair_products']}, ragged {res['ragged_products']}); "
        f"phase {time.monotonic() - t0:.1f} s")
    return res


def time_clay_pair(torch, dev, log, clay: dict) -> dict:
    """K1 on clay's 1x2 uncouple transform at the ``clay`` phase's write
    shape (one object's data grid: the kk*Z*(q-1)/q coupled symbols of
    s bytes each, side by side with their partners): device ms from a
    CUDA graph, the plain version's ms, and the bound of the 1x2 work
    itself, which K1 runs at its 4x4 row and column bucket."""
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.ops import gf256

    codec = codec_from_profile(CLAY_PROFILE, device=dev)
    P = int((~codec.dot[:codec.kk]).sum())
    W = P * clay["repair"]["s"]
    mat = codec._uncouple_M
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    bufs = rotating(torch, dev, g, 3, W)
    it = iter(range(1 << 30))

    def pair():
        b = bufs[next(it) % len(bufs)]
        gf256.gf_matmul_bytes(mat, b[:2], out=b[2:])

    ms = graph_ms(torch, pair)
    x = bufs[0][:2]
    err = int((gf256.gf_matmul_bytes(mat, x).int()
               - gf256.gf_matmul_bytes_plain(mat, x).int()).abs().max())
    plain_ms = event_ms(torch, lambda: gf256.gf_matmul_bytes_plain(mat, x),
                        5, warmup=1)
    bound_ms, by = bound(3 * W, gf_ops(mat, W // 4))
    log(f"gf256 clay 1x2 pair [2, {W}] (K1 at its 4x4 bucket): {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}), "
        f"max_abs_err {err}; the phase ran {clay['pair_products']} pair "
        f"products of {clay['products']} clay products")
    require(err == 0, "clay: K1's pair product equals its plain version")
    return {"shape": [2, W], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "launches": clay["pair_products"], "bucket": "4x4"}


def phase_bitmatrix(torch, dev, log) -> dict:
    return drive_path(torch, dev, log, "bitmatrix",
                      "plugin=jerasure k=8 m=4 technique=cauchy_good "
                      "packetsize=2048", lost=(6, 7, 10, 11),
                      need_write=("gf2_xor", "crc32c_rows"),
                      need_read=("gf2_xor",), absent=("gf2_matmul",),
                      queue_read=False)


def phase_shec(torch, dev, log) -> dict:
    res = drive_path(torch, dev, log, "shec", "plugin=shec k=8 m=4 c=3",
                     lost=(0, 1, 2),
                     need_write=("gf256_matmul", "crc32c_rows"),
                     need_read=("gf2_matmul",), absent=("gf2_xor",),
                     queue_read=False)
    # each degraded read: one contribution and one solve launch
    require(res["r_counts"]["gf2_matmul"] == 2 * res["nobj"],
            f"shec: two popcount launches per object read: {res['r_counts']}")
    return res


def phase_lrc(torch, dev, log, nobj: int = 64, obj_bytes: int = 4 * MiB,
              threads: int = 8) -> None:
    """lrc k=4 m=2 l=3 (Ceph's documented example): encode, lose one
    chunk of the first local group, rebuild it, and check the read plan
    stays inside that group."""
    from ceph_tpu_torch.ec import codec_from_profile

    codec = codec_from_profile("plugin=lrc k=4 m=2 l=3", device=dev)
    n = codec.get_chunk_count()
    lost = 1
    local = next(layer.chunks_set for layer in reversed(codec.layers)
                 if lost in layer.chunks_set)
    avail_ids = [i for i in range(n) if i != lost]
    minimum = set(codec.minimum_to_decode([lost], avail_ids))
    require(minimum <= local - {lost},
            f"lrc: minimum_to_decode {sorted(minimum)} stays in the local "
            f"group {sorted(local)}")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    objs = torch.randint(0, 256, (nobj, obj_bytes), dtype=torch.uint8,
                         device=dev, generator=g).cpu().numpy()
    chunks = [None] * nobj

    def write(i):
        chunks[i] = codec.encode(range(n), objs[i].tobytes())

    def read(i):
        got = codec.decode([lost], {c: chunks[i][c] for c in minimum})
        require(np.array_equal(got[lost], chunks[i][lost]),
                f"lrc: chunk {lost} of object {i} rebuilt exactly")
        require(codec.decode_concat({c: chunks[i][c] for c in avail_ids})
                [:obj_bytes] == objs[i].tobytes(),
                f"lrc: object {i} reads back whole without chunk {lost}")

    reset_counts()
    w_wall = run_threads(write, nobj, threads)
    r_wall = run_threads(read, nobj, threads)
    counts = read_counts()
    require(counts["gf256_matmul"] > 0, f"lrc: the GF(2^8) kernel ran: "
            f"{counts}")
    logical = nobj * obj_bytes
    log(f"lrc: plugin=lrc k=4 m=2 l=3, encoded {nobj} x "
        f"{obj_bytes >> 20} MiB in {w_wall:.3f} s = "
        f"{logical / w_wall / 1e9:.3f} GB/s; lost chunk {lost}, read plan "
        f"{sorted(minimum)} inside local group {sorted(local)}, rebuilt in "
        f"{r_wall:.3f} s; bytes exact; launches {counts}")


def crush_bound(stats, ids: int, result_max: int):
    """(bound ms, "bytes"/"operations") of a rule walk that made
    ``stats`` (straw2 draws, other hashes, ...) over ``ids`` ids: each id
    read once (4 B) and its row written once.  Every draw is priced as
    the full exact draw, whichever path the kernel took."""
    draws, others = (int(v) for v in stats[:2])
    return bound(ids * (4 + 4 * result_max),
                 draws * DRAW_OPS + others * HASH_OPS)


def phase_crush(torch, dev, log) -> dict:
    """K6 and K7 on the BASELINE configuration: build_flat_cluster(1024,
    hosts=64) (64 straw2 hosts of 16 OSDs under a straw2 root),
    chooseleaf firstn 3 type host over 10,485,760 ids, then the
    rebalance, the EC pool's indep 12, the small maps and crushtool."""
    import contextlib
    import io

    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.crush import mapper, samples
    from ceph_tpu_torch.ops import crush_rule
    from ceph_tpu_torch.tools import crushtool

    def firstn3(root):
        return [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
                (cmap.OP_EMIT, 0, 0)]

    m, root = cmap.build_flat_cluster(CRUSH_OSDS, hosts=CRUSH_HOSTS)
    flat = m.flatten()
    per = CRUSH_OSDS // CRUSH_HOSTS
    steps = firstn3(root)
    xs = torch.arange(CRUSH_IDS, dtype=torch.int32, device=dev)
    dw = np.full(CRUSH_OSDS, 0x10000, dtype=np.uint32)
    rm = mapper.device_map(flat, device=dev)

    def sweep(w, **kw):
        return mapper.sweep_device(flat, steps, 3, xs, w, chunk=CRUSH_CHUNK,
                                   device=dev, **kw)

    def hold(rows, stp, r, w, what, on=rm):
        """The kernel's rows for the first CRUSH_HOLD ids against the plain
        walk on the card, bit for bit; returns max |kernel - plain|."""
        ww = torch.from_numpy(w.view(np.int32)).to(dev)
        err = 0
        for lo in range(0, CRUSH_HOLD, 1 << 18):
            hi = min(lo + (1 << 18), CRUSH_HOLD)
            want, _ = crush_rule.rule_plain(
                on, crush_rule.RuleSpec(stp, r), ww, xs[lo:hi])
            got = rows[lo:hi]
            err = max(err, int((got.long() - want.long()).abs().max()))
            require(torch.equal(got, want), f"crush: {what}: kernel rows "
                    f"{lo}.. equal the plain walk's")
        return err

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        return res, time.monotonic() - t0

    # 1. the sweep: warm, then the main-path run between the counts
    sweep(dw)
    torch.cuda.synchronize()
    reset_counts()
    (placed, overflow), _ = timed(lambda: sweep(dw))
    counts = read_counts()
    n_chunks = CRUSH_IDS // CRUSH_CHUNK
    require(counts["crush_rule"] == n_chunks + 2
            and all(v == 0 for k, v in counts.items() if k != "crush_rule"),
            f"crush: the sweep ran one crush_rule launch a chunk, one "
            f"MID_BUDGET and one exact launch, and nothing else: {counts}")
    require(not bool(overflow), "crush: the healthy sweep does not overflow")
    walls = [timed(lambda: sweep(dw))[1] for _ in range(3)]
    sweep_s = float(np.median(walls))
    events = {}
    sweep(dw, stage_events=events)
    torch.cuda.synchronize()
    stages = {f"stage{k}": {"launches": len(v), "ms": sum(
        a.elapsed_time(b) for a, b in v)} for k, v in sorted(events.items())}

    # 2. the exact program over every id in one call
    full = mapper.compile_rule(flat, steps, 3, device=dev)
    full(xs[:CRUSH_CHUNK], dw)
    exact, exact_s = timed(lambda: full(xs, dw))
    require(torch.equal(placed, exact), "crush: the staged sweep equals the "
            f"exact program on all {CRUSH_IDS} ids")
    # the stages' loads: ids unclean after one attempt, after MID_BUDGET
    unclean = [int((~mapper.compile_rule(
        flat, steps, 3, budget=b, device=dev)(xs, dw)[1]).sum())
        for b in (1, mapper.MID_BUDGET)]
    stats = torch.zeros(crush_rule.N_STATS, dtype=torch.int64, device=dev)
    out = torch.empty_like(exact)
    crush_rule.launch(rm, full.spec, torch.from_numpy(dw.view(np.int32)).to(
        dev), xs, out, stats=stats)
    all_bound, all_by = crush_bound(stats.tolist(), CRUSH_IDS, 3)
    exact_share = stats[3].item() / stats[0].item()

    # 3. the kernel against the plain walk on the card
    err = hold(exact, steps, 3, dw, "healthy map")

    # 4. invariants over all ids
    require(bool(((exact >= 0) & (exact < CRUSH_OSDS)).all()),
            "crush: every row holds 3 OSDs, no ITEM_NONE")
    hosts = exact.long() // per
    require(bool(((hosts[:, 0] != hosts[:, 1]) & (hosts[:, 0] != hosts[:, 2])
                  & (hosts[:, 1] != hosts[:, 2])).all()),
            "crush: every row's 3 OSDs lie on 3 distinct hosts")
    per_osd = torch.bincount(exact.flatten().long(), minlength=CRUSH_OSDS
                             ).double()
    mean = float(per_osd.mean())
    log(f"crush: sweep_device of {CRUSH_IDS} ids (chooseleaf firstn 3 type "
        f"host, {CRUSH_OSDS} OSDs / {CRUSH_HOSTS} hosts, chunk "
        f"{CRUSH_CHUNK}): ids unclean after stage 1 {unclean[0]}, after "
        f"stage 2 {unclean[1]}; median {sweep_s * 1e3:.3f} ms = "
        f"{CRUSH_IDS / sweep_s:.4e} ids/s ({3 * CRUSH_IDS / sweep_s:.4e} "
        f"OSD placements/s), calls {[round(w * 1e3, 3) for w in walls]} ms, "
        f"stages {json.dumps(stages)}; exact program in one call "
        f"{exact_s * 1e3:.3f} ms, rows equal; walk stats {stats.tolist()} "
        f"(straw2 draws, other hashes, bucket choices, draws settled on the "
        f"exact path: {exact_share * 100:.5f} % of draws), bound "
        f"{all_bound:.4f} ms ({all_by}); per-OSD count min "
        f"{int(per_osd.min())} max {int(per_osd.max())} stddev "
        f"{float(per_osd.std()):.2f} mean {mean:.2f} "
        f"({float(per_osd.std()) / mean * 100:.3f} %)")

    # 5. rebalance: one host out, 8 OSDs at half weight
    dw2 = dw.copy()
    gone = np.arange(5 * per, 6 * per)
    half = np.arange(8) * 127 + 3
    dw2[gone], dw2[half] = 0, 0x8000
    (moved, overflow2), rebal_s = timed(lambda: sweep(dw2))
    if bool(overflow2):
        log("crush: the rebalance sweep overflowed its capacities; sweep() "
            "takes it")
        moved = torch.from_numpy(mapper.sweep(
            flat, steps, 3, xs, dw2, chunk=CRUSH_CHUNK, device=dev)).to(dev)
    require(torch.equal(moved, full(xs, dw2)),
            "crush: the rebalance sweep equals the exact program")
    require(not bool(torch.isin(moved, torch.from_numpy(gone).to(dev).to(
        torch.int32)).any()), "crush: no placement on a weight-0 OSD")
    share = float((moved != exact).sum()) / (3 * CRUSH_IDS)
    err = max(err, hold(moved, steps, 3, dw2, "rebalanced map"))
    log(f"crush: rebalance (host 5's {per} OSDs at weight 0, OSDs "
        f"{half.tolist()} at 0x8000): sweep {rebal_s * 1e3:.3f} ms, overflow "
        f"{bool(overflow2)}, {share * 100:.4f} % of placements moved")

    # 6. mixed weights: every fourth OSD at 0x20000, the hosts' weights
    # their sums; the host scans take the exact draw and its reciprocal
    mm, mroot = samples.weighted_cluster(CRUSH_OSDS, CRUSH_HOSTS)
    mflat, msteps = mm.flatten(), firstn3(mroot)
    mrm = mapper.device_map(mflat, device=dev)
    mfn = mapper.compile_rule(mflat, msteps, 3, device=dev)
    mfn(xs[:CRUSH_CHUNK], dw)
    mixed, mixed_s = timed(lambda: mfn(xs[:CRUSH_MIXED_IDS], dw))
    mstats = torch.zeros(crush_rule.N_STATS, dtype=torch.int64, device=dev)
    crush_rule.launch(mrm, mfn.spec, torch.from_numpy(dw.view(np.int32)).to(
        dev), xs[:CRUSH_MIXED_IDS], torch.empty_like(mixed), stats=mstats)
    mixed_share = mstats[3].item() / mstats[0].item()
    err = max(err, hold(mixed, msteps, 3, dw, "mixed-weight map", mrm))
    log(f"crush: mixed-weight map (every fourth OSD at 0x20000) "
        f"compile_rule over {CRUSH_MIXED_IDS} ids in {mixed_s * 1e3:.3f} ms "
        f"({CRUSH_MIXED_IDS / mixed_s:.4e} ids/s), walk stats "
        f"{mstats.tolist()}: {mixed_share * 100:.3f} % of draws settled on "
        "the exact path; the first CRUSH_HOLD rows equal the plain walk's")

    # 7. the EC pool of the main path (isa k=8 m=4): chooseleaf indep 12
    ec_steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_INDEP, 12, 1),
                (cmap.OP_EMIT, 0, 0)]
    ec_fn = mapper.compile_rule(flat, ec_steps, 12, device=dev)
    ec_fn(xs[:CRUSH_CHUNK], dw)
    ec, ec_s = timed(lambda: ec_fn(xs[:CRUSH_EC_IDS], dw))
    require(bool((ec != cmap.ITEM_NONE).all()),
            "crush: the healthy map leaves no hole in an indep 12 row")
    err = max(err, hold(ec, ec_steps, 12, dw, "indep 12"))
    log(f"crush: chooseleaf indep 12 over {CRUSH_EC_IDS} ids in "
        f"{ec_s * 1e3:.3f} ms, no holes")

    # 8. the small maps, every budget, kernel against plain
    n_small = 0
    for case in samples.cases():
        cflat = case.map.flatten()
        crm = mapper.device_map(cflat, case.choose_args, dev)
        spec = crush_rule.RuleSpec(case.steps, case.result_max)
        w = torch.from_numpy(case.dev_weights.view(np.int32)).to(dev)
        x = torch.from_numpy(samples.ids(17, 2048)).to(dev)
        for budget in (0, 1, 3):
            o = torch.empty((2048, case.result_max), dtype=torch.int32,
                            device=dev)
            c = torch.empty(2048, dtype=torch.uint8, device=dev)
            crush_rule.launch(crm, spec, w, x, o, budget=budget, clean=c)
            want, want_clean = crush_rule.rule_plain(crm, spec, w, x, budget)
            require(torch.equal(o, want) and torch.equal(c.bool(),
                                                         want_clean),
                    f"crush: small case {case.name} at budget {budget}: "
                    "kernel rows and clean flags equal the plain walk's")
            n_small += 1

    # 9. crushtool --test on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = crushtool.main(["--build", "--num_osds", str(CRUSH_OSDS),
                             "host", "straw2", str(per), "root", "straw2",
                             "0", "--test", "--num-rep", "3", "--min-x", "0",
                             "--max-x", str(CRUSH_HOLD - 1),
                             "--show-statistics", "--device", str(dev)])
    st = json.loads(buf.getvalue())["statistics"]
    require(rc == 0 and st["bad_mappings"] == 0
            and st["total_mappings"] == CRUSH_HOLD,
            f"crushtool --test: no bad mappings: {st}")
    log(f"crush: {n_small} small cases (every bucket algorithm, firstn and "
        "indep, choose_args, legacy tunables, OP_SET_* steps) at budgets 0, "
        f"1, 3 equal the plain walk; crushtool --test: {json.dumps(st)}")
    return {"launches": counts["crush_rule"], "max_abs_err": err,
            "sweep_ms": sweep_s * 1e3, "sweep_ids_per_s": CRUSH_IDS / sweep_s,
            "exact_ms": exact_s * 1e3, "stages": stages, "unclean": unclean,
            "sweep_bound_ms": all_bound, "walk_stats": stats.tolist(),
            "exact_share": exact_share, "mixed_ms": mixed_s * 1e3,
            "mixed_exact_share": mixed_share,
            "moved_share": share, "ec_ms": ec_s * 1e3, "rm": rm,
            "flat": flat, "steps": steps, "xs": xs, "dw": dw}


# -- the placement phase: OSDMap, its codec and incrementals, the balancers --

# BASELINE's 1024-OSD map (the crush phase's) under two pools sized by
# Ceph's placement-group guidance (about 100 PGs per OSD, split evenly
# between the pools and rounded to powers of two: 98,304 slots, 96 per
# OSD): (pool id, name, type, size, min_size, pg_num, profile)
PLACE_POOLS = ((1, "rbd", 1, 3, 2, 16384, ""),
               (2, "ec84", 3, 12, 9, 4096,
                "plugin=isa k=8 m=4 technique=reed_sol_van"))
PLACE_SCALAR = 512          # seeded PGs per pool through pg_to_up_acting
PLACE_MOVES = 64            # the upmap balancer's max_moves (its default)
PLACE_HOST = 5              # the host marked down and out


def placement_map(dev, n_osds: int = CRUSH_OSDS, hosts: int = CRUSH_HOSTS,
                  pools=PLACE_POOLS):
    """build_flat_cluster(n_osds, hosts) with a replicated pool on
    ``chooseleaf firstn 0 type host`` and an erasure pool on ``chooseleaf
    indep <size> type host``, as an OSDMap on ``dev``."""
    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool, POOL_REPLICATED

    cm, root = cmap.build_flat_cluster(n_osds, hosts=hosts)
    m = OSDMap(cm, max_osd=n_osds, device=dev)
    for pid, name, ptype, size, min_size, pg_num, profile in pools:
        firstn = ptype == POOL_REPLICATED
        rid = cm.add_simple_rule(name, root, 1,
                                 mode="firstn" if firstn else "indep",
                                 num=0 if firstn else size)
        m.add_pool(PGPool(pid, ptype, size=size, min_size=min_size,
                          pg_num=pg_num, pgp_num=pg_num, crush_rule=rid,
                          erasure_code_profile=profile, name=name))
    return m


def run_placement(torch, dev, *, n_osds: int = CRUSH_OSDS,
                  hosts: int = CRUSH_HOSTS, pools=PLACE_POOLS,
                  scalar: int = PLACE_SCALAR, moves: int = PLACE_MOVES,
                  compat_iters: int = 12, tool_osds: int = CRUSH_OSDS,
                  tool_pg_num: int = 16384, reps: int = 3) -> dict:
    """Placement on the host over the rule walk, each step a check that
    fails the run: both pools swept by ``map_pgs`` (one K6 launch a pool
    a call, median of ``reps``), held against the same map decoded onto
    the CPU (the plain walk); ``pg_to_up_acting`` on ``scalar`` seeded
    PGs a pool (one launch each) equal to the sweep's rows; a host marked
    down and out through an encoded Incremental; the upmap balancer on
    both pools, its map carried by an Incremental into a clone; the
    crush-compat balancer on pool 1; osdmaptool and crushtool on a map
    of ``tool_osds`` OSDs.  Returns the numbers and the K6 launches
    the steps made (``launches``), counted between zeroed counts."""
    import contextlib
    import io
    import os
    import tempfile

    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.crush.compiler import decompile
    from ceph_tpu_torch.mgr.balancer import (CrushCompatBalancer,
                                             UpmapBalancer)
    from ceph_tpu_torch.osd import map_codec, map_inc
    from ceph_tpu_torch.ops import crush_rule
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE as NONE
    from ceph_tpu_torch.osd.osdmap import seeds_as_ids
    from ceph_tpu_torch.tools import crushtool, osdmaptool

    dev = torch.device(dev)
    t_phase = time.perf_counter()
    res = {"launches": 0, "sweep_ms": {}, "ids_per_s": {}, "plain_ms": {},
           "moved": {}, "balance": {}}

    def counted(what, fn, want=None):
        """fn() between zeroed launch counts: only K6 may launch, ``want``
        times where given; returns fn's result and its wall seconds."""
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        c = read_counts()
        res["launches"] += c["crush_rule"]
        require(all(v == 0 for k, v in c.items() if k != "crush_rule"),
                f"placement: {what} launched only crush_rule: {c}")
        if dev.type == "cuda" and want is not None:
            require(c["crush_rule"] == want, f"placement: {what} made "
                    f"{want} crush_rule launches: {c}")
        return out, wall

    m = placement_map(dev, n_osds, hosts, pools)
    per = n_osds // hosts
    sweeps = {}

    def walker(pool, n):
        """The pool's rule walk alone (a call uploads the ids and the
        weights, launches and copies the rows back) and the ids of its
        first n PGs."""
        fn = mapper.compile_rule(m.crush.flatten(),
                                 m.crush.rules[pool.crush_rule].steps,
                                 pool.size, device=dev)
        return fn, seeds_as_ids(pool.pps_vector(np.arange(n)))

    # 1. each pool swept: warm (the device map's upload), then timed,
    # and its walk alone, to split the sweep's wall
    res["walk_ms"] = {}
    for pid, pool in m.pools.items():
        counted(f"map_pgs({pid}) warm", lambda: m.map_pgs(pid), 1)
        fn, ids = walker(pool, pool.pg_num)
        walls, walks = [], []
        for _ in range(reps):
            sweeps[pid], wall = counted(f"map_pgs({pid})",
                                        lambda: m.map_pgs(pid), 1)
            walls.append(wall)
            walks.append(counted(f"walk({pid})", lambda: fn(
                ids, m.osd_weight).cpu(), 1)[1])
        s = float(np.median(walls))
        res["sweep_ms"][pid] = s * 1e3
        res["walk_ms"][pid] = float(np.median(walks)) * 1e3
        res["ids_per_s"][pid] = pool.pg_num / s

    # 2. the same map decoded onto the CPU: the plain walk's rows
    cpu = map_codec.decode_osdmap(map_codec.encode_osdmap(m), device="cpu")
    err = 0
    for pid in m.pools:
        t0 = time.perf_counter()
        want = cpu.map_pgs(pid)
        res["plain_ms"][pid] = (time.perf_counter() - t0) * 1e3
        for k in want:
            require(np.array_equal(sweeps[pid][k], want[k]), f"placement: "
                    f"pool {pid} {k} rows equal the plain walk's")
        err = max(err, int(np.abs(sweeps[pid]["raw"].astype(np.int64)
                                  - want["raw"]).max()))
    res["max_abs_err"] = err

    # 3. the per-op path: one launch per call, equal to the sweep's row
    rng = np.random.default_rng(SEED + 15)
    calls, scalar_s = 0, 0.0
    for pid, pool in m.pools.items():
        pgs = rng.choice(pool.pg_num, min(scalar, pool.pg_num),
                         replace=False)
        got, wall = counted(f"pg_to_up_acting x {len(pgs)}", lambda: [
            m.pg_to_up_acting((pid, int(ps))) for ps in pgs], len(pgs))
        calls, scalar_s = calls + len(pgs), scalar_s + wall
        sw = sweeps[pid]
        for ps, (up, upp, act, actp) in zip(pgs, got):
            row = [int(v) for v in sw["up"][ps]]
            if pool.can_shift_osds():
                row = [v for v in row if v != NONE]
            require(up == row and act == row and upp == sw["up_primary"][ps]
                    and actp == sw["acting_primary"][ps],
                    f"placement: pg {pid}.{ps:x} scalar equals the sweep")
    res["scalar_calls_per_s"] = calls / scalar_s
    # the share of a call that is the N=1 walk itself: the two uploads,
    # the launch and the copy back, without the pipeline's host work
    fn, ids = walker(m.pools[1], min(scalar, m.pools[1].pg_num))
    _, walk_s = counted("the N=1 walk", lambda: [
        fn(ids[i:i + 1], m.osd_weight).cpu() for i in range(len(ids))],
        len(ids))
    res["walk_us"] = walk_s / len(ids) * 1e6

    # 4. a host down and out, shipped as an encoded Incremental
    base = map_inc.clone_map(m)
    changed = map_inc.clone_map(m)
    gone = list(range(PLACE_HOST * per, (PLACE_HOST + 1) * per))
    for osd in gone:
        changed.set_osd_down(osd)
        changed.set_osd_out(osd)
    blob = map_inc.diff_maps(base, changed).encode()
    applied = map_inc.Incremental.decode(blob).apply(base)
    require(map_codec.encode_osdmap(applied)
            == map_codec.encode_osdmap(changed),
            "placement: the applied Incremental equals the changed map")
    slots = moved = 0
    for pid in m.pools:
        after, _ = counted(f"map_pgs({pid}) host out",
                           lambda: applied.map_pgs(pid), 1)
        up0, up1 = sweeps[pid]["up"], after["up"]
        require(not np.isin(up1, gone).any(), f"placement: pool {pid}: no "
                "up row holds an out OSD")
        keep = ~np.isin(up0, gone).any(axis=1)
        require(np.array_equal(up1[keep], up0[keep]), f"placement: pool "
                f"{pid}: PGs with no member on host {PLACE_HOST} keep their "
                "up rows")
        n_moved = int((up1 != up0).sum())
        res["moved"][pid] = n_moved / up0.size
        slots, moved = slots + up0.size, moved + n_moved
    res["moved_share"] = moved / slots
    res["inc_bytes"] = len(blob)

    # 5. the upmap balancer on both pools; its map carried into a clone
    unbalanced = map_inc.clone_map(m)
    bal = UpmapBalancer(m, max_deviation=1.0, max_moves=moves)
    for pid in m.pools:
        rep, wall = counted(f"upmap balancer pool {pid}",
                            lambda: bal.optimize_pool(pid))
        require(rep.after_stddev <= rep.before_stddev and rep.moves,
                f"placement: pool {pid} upmap balancer moved and did not "
                f"raise the stddev: {rep.before_stddev} -> "
                f"{rep.after_stddev}, {len(rep.moves)} moves")
        up, _ = counted(f"map_pgs({pid}) balanced",
                        lambda: m.map_pgs(pid)["up"], 1)
        for (_, ps), _ in rep.moves:
            osds = [int(o) for o in up[ps] if o != NONE]
            doms = [bal.domain_of[o] for o in osds]
            require(len(set(doms)) == len(doms), f"placement: pg {pid}."
                    f"{ps:x} keeps its failure domain: {osds}")
        res["balance"][f"upmap_{pid}"] = {
            "before": rep.before_stddev, "after": rep.after_stddev,
            "moves": len(rep.moves), "wall_s": wall}
    inc = map_inc.Incremental.decode(
        map_inc.diff_maps(unbalanced, m).encode())
    carried = inc.apply(unbalanced)
    for pid in m.pools:
        (got, want), _ = counted(f"map_pgs({pid}) carried", lambda: (
            carried.map_pgs(pid), m.map_pgs(pid)), 2)
        require(all(np.array_equal(got[k], want[k]) for k in want),
                f"placement: pool {pid}: the carried map places as the "
                "balanced one")
    res["upmap_inc_bytes"] = len(inc.encode())

    # 6. the crush-compat balancer on pool 1: a new device map per step
    compat = map_inc.clone_map(unbalanced)
    rep, wall = counted("crush-compat balancer", lambda: CrushCompatBalancer(
        compat, max_iterations=compat_iters).optimize([1]))
    require(rep.after_stddev <= rep.before_stddev and not rep.moves
            and not compat.pg_upmap_items and "-1" in compat.crush.choose_args,
            f"placement: crush-compat did not raise the stddev: "
            f"{rep.before_stddev} -> {rep.after_stddev}")
    res["balance"]["crush_compat_1"] = {
        "before": rep.before_stddev, "after": rep.after_stddev,
        "iterations": compat_iters, "wall_s": wall}
    # what each of its steps pays for a new map: the flat arrays, then
    # their device copy (each step's map_pgs builds both)
    t0 = time.perf_counter()
    flat = compat.crush.flatten()
    t1 = time.perf_counter()
    crush_rule.RuleMap(flat, None, dev).tables()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res["flatten_ms"] = (t1 - t0) * 1e3
    res["upload_ms"] = (time.perf_counter() - t1) * 1e3

    # 7. osdmaptool and crushtool on their map files
    dev_args = [] if dev.type == "cuda" else ["--device", str(dev)]

    def tool(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = fn(argv + dev_args)
        require(rc == 0, f"placement: {argv} exits 0")
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        f, cf = os.path.join(tmp, "osdmap"), os.path.join(tmp, "crush")
        tool(osdmaptool.main, ["--createsimple", str(tool_osds),
                               "--pg_num", str(tool_pg_num), "-o", f])
        out, _ = counted("osdmaptool --test-map-pgs", lambda: json.loads(
            tool(osdmaptool.main, [f, "--test-map-pgs"])), 1)
        require(out["pool_pgs_examined"] == tool_pg_num
                and sum(out["osd_pg_counts"].values()) == 3 * tool_pg_num,
                f"placement: osdmaptool --test-map-pgs: {out['summary']}")
        up, wall = counted("osdmaptool --upmap", lambda: json.loads(tool(
            osdmaptool.main, [f, "--upmap", "--upmap-max", str(moves)])))
        sd = up["stddev"]["pool.1"]
        require(up["upmaps"] and sd["after"] <= sd["before"],
                f"placement: osdmaptool --upmap: {sd}")
        with open(f, "rb") as fh:
            tm = map_codec.decode_osdmap(fh.read(), device=dev)
        with open(cf, "wb") as fh:
            fh.write(map_inc.crush_bytes(tm))
        text = tool(crushtool.main, ["-d", "-i", cf])
        require(text == decompile(tm.crush), "placement: crushtool -d -i "
                "of the map's binary crush map")
        res["tool"] = {"summary": out["summary"], "upmaps": len(up["upmaps"]),
                       "stddev": sd, "upmap_wall_s": wall}
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def phase_placement(torch, dev, log) -> dict:
    """``run_placement`` at full width: the crush phase's 1024-OSD map
    with a 16384-PG replicated pool and a 4096-PG isa k=8 m=4 pool."""
    res = run_placement(torch, dev)
    names = {p[0]: p[1] for p in PLACE_POOLS}
    sweep = ", ".join(
        f"{names[p]} {res['sweep_ms'][p]:.3f} ms ({res['ids_per_s'][p]:.4e} "
        f"PGs/s; its walk alone {res['walk_ms'][p]:.3f} ms; plain walk on "
        f"the CPU {res['plain_ms'][p]:.1f} ms)"
        for p in res["sweep_ms"])
    bal = "; ".join(
        f"{k}: stddev {v['before']:.4f} -> {v['after']:.4f}, "
        f"{v.get('moves', 0)} moves, {v['wall_s']:.3f} s"
        for k, v in res["balance"].items())
    log(f"placement: {CRUSH_OSDS} OSDs / {CRUSH_HOSTS} hosts; map_pgs "
        f"median of 3, one crush_rule launch each: {sweep}; rows equal the "
        f"plain walk's; pg_to_up_acting {res['scalar_calls_per_s']:.1f} "
        f"calls/s (one launch each; the N=1 walk alone {res['walk_us']:.1f} "
        f"us a call), equal to the sweep; host "
        f"{PLACE_HOST} down and out by a {res['inc_bytes']} B Incremental: "
        f"{res['moved_share'] * 100:.4f} % of slots moved "
        f"({json.dumps(res['moved'])}), no out OSD up, untouched PGs kept; "
        f"{bal} (a new map: flatten {res['flatten_ms']:.3f} ms, device "
        f"copy {res['upload_ms']:.3f} ms); the upmap map carried by a {res['upmap_inc_bytes']} B "
        f"Incremental places the same; osdmaptool on {CRUSH_OSDS} OSDs: "
        f"{json.dumps(res['tool'])}; crushtool -d -i of its crush map; "
        f"{res['launches']} crush_rule launches; phase "
        f"{res['wall_s']:.1f} s")
    return res


def time_crush(torch, dev, log, cr: dict, sass: dict) -> dict:
    """K6's row: the main path's commonest launch (the one-attempt pass
    over one chunk) from a CUDA graph, the exact walk over a chunk, the
    eager compile_rule call, the plain walk, and the bound of that
    launch's own work."""
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.ops import crush_rule

    rm, xs = cr["rm"], cr["xs"][:CRUSH_CHUNK]
    spec = crush_rule.RuleSpec(cr["steps"], 3)
    w = torch.from_numpy(cr["dw"].view(np.int32)).to(dev)
    out = torch.empty((CRUSH_CHUNK, 3), dtype=torch.int32, device=dev)
    bad = torch.empty(CRUSH_CHUNK // 8, dtype=torch.int32, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = graph_ms(torch, lambda: crush_rule.launch(
        rm, spec, w, xs, out, budget=1, bad=bad, bad_count=cnt), iters=5,
        reps=3)
    exact_ms = graph_ms(torch, lambda: crush_rule.launch(
        rm, spec, w, xs, out), iters=5, reps=3)
    fn = mapper.compile_rule(cr["flat"], cr["steps"], 3, device=dev)
    call_ms = event_ms(torch, lambda: fn(xs, cr["dw"]), 5)
    plain_ms = event_ms(torch, lambda: crush_rule.rule_plain(
        rm, spec, w, xs, 1), 1, warmup=1)
    stats = torch.zeros(crush_rule.N_STATS, dtype=torch.int64, device=dev)
    crush_rule.launch(rm, spec, w, xs, out, budget=1, bad=bad, bad_count=cnt,
                      stats=stats)
    b_ms, b_by = crush_bound(stats.tolist(), CRUSH_CHUNK, 3)
    c = sass["crush_rule"]
    # the straw2 loop's ALU-pipe issue floor: its instructions per draw
    # over 16 lanes a cycle on each of 4 schedulers, every SM, at the
    # card's top SM clock
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    alu_ms = (stats[0].item() * c["straw2_alu_per_draw"]
              / (64 * sms * mhz * 1e6) * 1e3)
    log(f"crush_rule: one-attempt launch over {CRUSH_CHUNK} ids {ms:.4f} ms "
        f"(bound {b_ms:.4f} ms, {b_by}; the straw2 loop's ALU issue floor "
        f"{alu_ms:.4f} ms: {stats[0].item()} draws x "
        f"{c['straw2_alu_per_draw']:.1f} / (64 x {sms} SMs x {mhz:.0f} "
        f"MHz)), exact launch {exact_ms:.4f} ms, eager compile_rule call "
        f"{call_ms:.4f} ms, plain {plain_ms:.1f} ms")
    return {"name": "crush_rule", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/crush.cu",
            "replaces": "ceph_tpu/crush/mapper.py:1103",
            "launches": cr["launches"], "max_abs_err": cr["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "call_ms": call_ms,
            "exact_chunk_ms": exact_ms, "regs": c["regs"],
            "stack": c["stack"], "local": c["local"],
            "sweep_ms": cr["sweep_ms"], "sweep_ids_per_s":
            cr["sweep_ids_per_s"], "exact_ms": cr["exact_ms"],
            "sweep_bound_ms": cr["sweep_bound_ms"], "stages": cr["stages"],
            "unclean": cr["unclean"], "alu_floor_ms": alu_ms,
            "exact_share": cr["exact_share"], "mixed_ms": cr["mixed_ms"],
            "mixed_exact_share": cr["mixed_exact_share"],
            "sass": {"crush_rule": c}}


def phase_ecbench(torch, dev, log) -> dict:
    """The port's EC engine bench at its full sizes: K2's path."""
    from ceph_tpu_torch.tools import ecbench

    reset_counts()
    res = ecbench.run(dev, target_s=ECBENCH_TARGET_S, cap_s=ECBENCH_CAP_S,
                      log=log)
    counts = read_counts()
    require(counts["gf256_interleaved"] > 0 and counts["gf256_matmul"] > 0,
            f"ecbench: K2 and K1 ran: {counts}")
    require(res["ec_device_pinned"] == {"planar": True, "inter": True}
            and res["ec_decode_pinned"] is True, "ecbench: both pins hold")
    sweep = res["ec_sweep"]
    sizes = sorted(int(size) for size in sweep)
    require(sizes == [MiB << i for i in (0, 2, 4, 6, 8)]
            and all(isinstance(c[key], float) for r in sweep.values()
                    for c in (r["layouts"]["planar"], r["layouts"]["inter"])
                    for key in ("encode_gbps", "decode_gbps")),
            "ecbench: encode and decode sweeps of K1 and K2 from 1 to 256 "
            "MiB")
    log("ecbench: " + json.dumps({
        "winner": res["ec_engine"], "tune_gbps": res["ec_engine_tune_gbps"],
        "sweep": sweep, "hbm_frac": res["encode_hbm_frac"],
        "host_path_gbps": res["encode_1mib_host_path_gbps"],
        "small_stripe": {k: v for k, v in res.items()
                         if k.startswith("small_stripe")},
        "envelope": res.get("envelope"), "launches": counts,
        "elapsed_s": res["elapsed_s"]}))
    return {"res": res, "counts": counts}


def time_gf256i(torch, dev, log, eb: dict) -> dict:
    """K2 at 16 MiB (T = 4096, k=8 m=4) with the bench's best
    interleaved variant, rotating buffers beyond the 50 MB L2."""
    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.ops import benchloop
    from ceph_tpu_torch.ops import gf256_planes as gp

    tune = eb["res"]["ec_engine_tune_gbps"]
    best = max((n for n, v in tune.items()
                if n.startswith("inter_") and isinstance(v, float)),
               key=tune.get)
    tile = int(best.split("_")[1][1:])
    ms = best.endswith("_shift")
    mat = matrices.isa_cauchy(8, 4)
    T, k, R = 4096, 8, 4
    nbuf = 8
    bufs = [benchloop.gen_planes(k, T, True, device=dev) ^ (i * 0x01010101)
            for i in range(nbuf)]
    outs = [torch.empty((T, R, 128), dtype=torch.int32, device=dev)
            for _ in range(nbuf)]
    it = iter(range(1 << 30))

    def enc():
        i = next(it) % nbuf
        gp.encode_planes_interleaved(mat, bufs[i], 0, tile=tile,
                                     mul_shift=ms, out=outs[i])

    ms_k = graph_ms(torch, enc)
    call_ms = event_ms(torch, enc, 40)
    x = bufs[0]
    got = gp.encode_planes_interleaved(mat, x, 0, tile=tile, mul_shift=ms)
    want = gp.encode_planes_interleaved_plain(mat, x)
    err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF))
              .abs().max().item())
    plain_ms = event_ms(torch, lambda: gp.encode_planes_interleaved_plain(
        mat, x), 3, warmup=1)
    b_ms, b_by = bound((k + R) * T * 512, gf_ops(mat, T * 128))
    log(f"gf256_interleaved at 16 MiB with {best}: {ms_k:.4f} ms, per "
        f"eager call {call_ms:.4f} ms")
    return {"name": "gf256_interleaved", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf256.cu",
            "replaces": "ceph_tpu/ops/gf256_pallas.py:192",
            "launches": eb["counts"]["gf256_interleaved"],
            "max_abs_err": err, "ms": ms_k, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "call_ms": call_ms}


def time_gf2(torch, dev, log, bm: dict) -> dict:
    """K3's XOR kernel at the bitmatrix path's coalesced write batch: J
    jobs of one object's [k, width] planes side by side, w packets each.
    Its bound counts the work these inputs need: each byte read or
    written once, and one u32 XOR per 4 bytes of every listed packet
    row."""
    from ceph_tpu_torch.ops import gf2_matmul as g2

    codec = bm["codec"]
    k, m, w = codec.k, codec.m, codec.w
    width = bm["width"]
    J, P = batch_shape(bm)
    offs, widths = [i * width for i in range(J)], [width] * J
    op = codec.operand(codec.coding_bits)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    bufs = rotating(torch, dev, g, k + m, P)
    it = iter(range(1 << 30))

    def enc():
        b = bufs[next(it) % len(bufs)]
        g2.gf2_matmul_packets(op, b[:k], b[k:], offs, widths, w)

    ms = graph_ms(torch, enc)
    call_ms = event_ms(torch, enc, 40)
    x = bufs[0][:k]

    def plain():
        return g2.gf2_matmul_packets_plain(
            op, x, torch.zeros((m, P), dtype=torch.uint8, device=dev),
            offs, widths, w)

    got = g2.gf2_matmul_packets(
        op, x, torch.zeros((m, P), dtype=torch.uint8, device=dev), offs,
        widths, w)
    err = int((got.int() - plain().int()).abs().max().item())
    plain_ms = event_ms(torch, plain, 3, warmup=1)
    cols = sum(widths) // w  # packet columns the product runs over
    nnz = int(op.packet.sum())
    b_ms, b_by = bound((k + m) * sum(widths), nnz * cols // 4)

    dop = codec.operand(codec.recovery_bits(bm["survivors"][:k]))
    dec_ms = graph_ms(torch, lambda: g2.gf2_matmul_packets(
        dop, bufs[next(it) % len(bufs)][:k], bufs[0][:k], [0], [width], w))
    dec_bound, _ = bound(2 * k * width,
                         int(dop.packet.sum()) * (width // w) // 4)
    log(f"gf2_xor decode {list(dop.mbits.shape)} ({int(dop.packet.sum())} "
        f"packet XORs) on one object [{k}, {width}]: {dec_ms:.4f} ms (bound "
        f"{dec_bound:.4f} ms); encode batch per eager call "
        f"{call_ms:.4f} ms")
    return {"name": "gf2_xor", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf2_matmul.cu",
            "replaces": "ceph_tpu/ops/gf2_matmul.py:87",
            "launches": bm["counts"]["gf2_xor"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "call_ms": call_ms}


def time_gf2_popcount(torch, dev, log, sh: dict) -> dict:
    """K3's popcount kernel at the shec path's two read shapes, one object
    each: the [24, 64] contribution operand on the [k, width] data planes
    (the row's ``ms``) and the [24, 24] solve operand on the [3, width]
    residual (``solve_ms``).  Each read launches both once, so each shape
    takes half the path's launches.  Their bounds keep the JAX kernel's
    int8 operation count (it evaluates every bit product, as the tensor
    cores do)."""
    from ceph_tpu_torch.ops import gf2_matmul as g2

    codec = sh["codec"]
    k, width = codec.k, sh["width"]
    lost = tuple(s for s in range(k) if s not in sh["survivors"])
    _, s_op, c_op = codec.solve_operands(lost, tuple(sh["survivors"]))
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    res = {}
    for name, op in (("contrib", c_op), ("solve", s_op)):
        bufs = rotating(torch, dev, g, op.K, width)
        outs = [torch.empty((op.R, width), dtype=torch.uint8, device=dev)
                for _ in bufs]
        it = iter(range(1 << 30))

        def dec():
            i = next(it) % len(bufs)
            g2.gf2_matmul_bytes(op, bufs[i], out=outs[i])

        ms = graph_ms(torch, dec)
        call_ms = event_ms(torch, dec, 40)
        x = bufs[0]
        want = g2.gf2_matmul_bytes_plain(op, x)
        err = int((g2.gf2_matmul_bytes(op, x).int() - want.int()).abs()
                  .max().item())
        plain_ms = event_ms(torch, lambda: g2.gf2_matmul_bytes_plain(op, x),
                            3, warmup=1)
        b_ms, b_by = bound((op.K + op.R) * width,
                           2 * op.mbits.shape[0] * op.mbits.shape[1] * width,
                           INT8_OPS_PER_S)
        res[name] = {"ms": ms, "call_ms": call_ms, "err": err,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "launches": sh["r_counts"]["gf2_matmul"] // 2}
        log(f"gf2_matmul (popcount) {name} {list(op.mbits.shape)} on "
            f"[{op.K}, {width}]: {ms:.4f} ms (bound {b_ms:.4f} ms, "
            f"{b_by}), per eager call {call_ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, max_abs_err {err}")
    c, sv = res["contrib"], res["solve"]
    return {"name": "gf2_matmul", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf2_matmul.cu",
            "replaces": "ceph_tpu/ops/gf2_matmul.py:87",
            "launches": sh["counts"]["gf2_matmul"],
            "max_abs_err": max(c["err"], sv["err"]),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None, "call_ms": c["call_ms"],
            "contrib_launches": c["launches"], "solve_ms": sv["ms"],
            "solve_call_ms": sv["call_ms"], "solve_plain_ms": sv["plain_ms"],
            "solve_bound_ms": sv["bound_ms"],
            "solve_launches": sv["launches"]}


def time_kernels(torch, dev, log, main: dict) -> list:
    from ceph_tpu_torch.ops import crc32c_device as cd
    from ceph_tpu_torch.ops import gf256

    codec = main["codec"]
    k, m = codec.k, codec.m
    width = main["width"]
    J, P = batch_shape(main)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    bufs = rotating(torch, dev, g, k + m, P)
    nbuf = len(bufs)
    mat = codec.coding_u8
    it = iter(range(1 << 30))

    def enc():
        b = bufs[next(it) % nbuf]
        gf256.gf_matmul_bytes(mat, b[:k], out=b[k:])

    gf_ms = graph_ms(torch, enc)
    gf_call_ms = event_ms(torch, enc, 40)
    x = bufs[0][:k]
    ref = gf256.gf_matmul_bytes_plain(mat, x)
    got = gf256.gf_matmul_bytes(mat, x)
    gf_err = int((got.int() - ref.int()).abs().max().item())
    gf_plain_ms = event_ms(torch, lambda: gf256.gf_matmul_bytes_plain(mat, x),
                           5, warmup=1)
    gf_bound, gf_by = bound((k + m) * P, gf_ops(mat, P // 4))

    rec, _ = codec.recovery_matrix(main["survivors"])
    dec_ms = graph_ms(torch, lambda: gf256.gf_matmul_bytes(
        rec, bufs[next(it) % nbuf][:k], donate=True))
    dec_bound, _ = bound(2 * k * P, gf_ops(rec, P // 4))
    log(f"gf256 decode 8x8 donated [8, {P}]: {dec_ms:.4f} ms "
        f"(bound {dec_bound:.4f} ms)")

    offs, lens = [i * width for i in range(J)], [width] * J

    # the kernel alone: its table, scratch and output staged once
    staged = cd._stage_rows(dev, k + m, np.asarray(offs, np.int64),
                            np.asarray(lens, np.int64), np.zeros(J, np.int64))

    def crc():
        b = bufs[next(it) % nbuf]
        cd._run_rows(b, b.stride(0), k + m, staged)

    crc_ms = graph_ms(torch, crc)
    # the whole wrapper call: table upload, launch, digest fetch
    crc_call_ms = event_ms(torch, lambda: cd.crc32c_rows(
        bufs[next(it) % nbuf], offs, lens), 40)
    log(f"crc32c_rows [{k + m}, {P}] x {J} jobs: kernel {crc_ms:.4f} ms, "
        f"per crc32c_rows call (upload, launch, fetch) {crc_call_ms:.4f} "
        f"ms; gf256 encode per eager call {gf_call_ms:.4f} ms")
    got = cd.crc32c_rows(bufs[0], offs, lens).astype(np.int64)
    t0 = time.monotonic()
    want = rows_plain(torch, bufs[0], offs, lens, [0] * J).astype(np.int64)
    torch.cuda.synchronize()
    crc_plain_ms = (time.monotonic() - t0) * 1e3
    crc_err = int(np.abs(got - want).max())
    crc_bound, crc_by = bound((k + m) * sum(lens) + 4 * J * (k + m),
                              (k + m) * sum(lens) // 8 * 22)
    return [
        {"name": "gf256_matmul", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf256.cu",
         "replaces": "ceph_tpu/ops/gf256_pallas.py:81",
         "launches": main["counts"]["gf256_matmul"], "max_abs_err": gf_err,
         "ms": gf_ms, "plain_ms": gf_plain_ms, "bound_ms": gf_bound,
         "bound_by": gf_by, "library_ms": None, "call_ms": gf_call_ms,
         "dec_ms": dec_ms, "dec_bound_ms": dec_bound},
        {"name": "crc32c_rows", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crc32c.cu",
         "replaces": "ceph_tpu/ops/crc32c_device.py:75",
         "launches": main["counts"]["crc32c_rows"], "max_abs_err": crc_err,
         "ms": crc_ms, "plain_ms": crc_plain_ms, "bound_ms": crc_bound,
         "bound_by": crc_by, "library_ms": None, "call_ms": crc_call_ms},
    ]


MESH_BIG = (12, 64 * MiB)    # the digest kernel's second timed shape


def time_mesh_digest(torch, dev, log, mesh: dict) -> dict:
    """The ``mesh_digest`` row: ``ms`` from a CUDA graph of launches over
    rotating [12, 512 Ki] buffers (the digest step's shape: one object's
    stored shards), ``call_ms`` the eager wrapper call, the plain
    version's time, and ``library_ms`` for ``x.sum(dtype=torch.int64)``,
    one PyTorch call over the same bytes (the digest is that sum times a
    constant mod 2^32); then the same at [12, 64 Mi] (``big``).  The bound
    is the bytes read once at 3.35 TB/s (one dp4a a word is far below the
    integer peak)."""
    from ceph_tpu_torch.ops import mesh_digest as md

    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def timed(bufs) -> dict:
        nbuf = len(bufs)
        out = torch.empty(2, dtype=torch.int64, device=dev)
        it = iter(range(1 << 30))
        ms = graph_ms(torch, lambda: md.mesh_digest(
            bufs[next(it) % nbuf], out=out))
        call_ms = event_ms(torch, lambda: md.mesh_digest(
            bufs[next(it) % nbuf]), 40)
        lib_ms = event_ms(torch, lambda: bufs[next(it) % nbuf].sum(
            dtype=torch.int64), 40)
        x = bufs[0]
        plain = md.mesh_digest_plain(x)
        err = abs(int(md.mesh_digest(x)) - int(plain))
        plain_ms = event_ms(torch, lambda: md.mesh_digest_plain(x), 3,
                            warmup=1)
        rows, n = x.shape
        b, by = bound(rows * n + 8, rows * n // 4)
        return {"shape": [rows, n], "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b,
                "bound_by": by, "max_abs_err": err}

    rows, width = mesh["digest_shape"]
    small = timed(rotating(torch, dev, g, rows, width))
    big = timed([torch.randint(0, 256, MESH_BIG, dtype=torch.uint8,
                               device=dev, generator=g)])
    torch.cuda.empty_cache()
    for r in (small, big):
        log(f"mesh_digest {r['shape']}: {r['ms']:.4f} ms (graph), call "
            f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            f"x.sum(int64) {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']}")
    return {"name": "mesh_digest", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/meshio.cu",
            "replaces": "ceph_tpu/tpu/meshio.py:216",
            "launches": mesh["d_counts"]["mesh_digest"],
            **{k: small[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "call_ms", "shape")},
            "big": big}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from ceph_tpu_torch.ops import _build

    card = card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.monotonic()

    def log(msg: str) -> None:
        print(f"[{card} | t={time.monotonic() - t_run:.1f}s] {msg}",
              flush=True)

    _build.lib()
    log(f"build: kernels built in {_build.build_seconds:.1f} s "
        f"into {_build.BUILD_DIR}")
    sass = kernel_sass(log)
    phase_gf256(torch, dev, log)
    phase_crc(torch, dev, log)
    phase_gf2(torch, dev, log)
    phase_gf256i(torch, dev, log)
    main_res = phase_main(torch, dev, log)
    mesh_res = phase_mesh(torch, dev, log, main_res)
    del main_res["planes"], main_res["coding"]
    phase_core(torch, dev, log)
    wire_res = phase_wire(torch, dev, log)
    rec_res = phase_recovery(torch, dev, log, wire_res)
    scr_res = phase_scrub(torch, dev, log, wire_res)
    dmn_res = phase_daemon(torch, dev, log)
    cls_res = phase_cluster(torch, dev, log)
    clay_res = phase_clay(torch, dev, log)
    vs_res = phase_vstart(torch, dev, log)
    bm_res = phase_bitmatrix(torch, dev, log)
    sh_res = phase_shec(torch, dev, log)
    phase_lrc(torch, dev, log)
    cr_res = phase_crush(torch, dev, log)
    pl_res = phase_placement(torch, dev, log)
    eb_res = phase_ecbench(torch, dev, log)
    kernels = time_kernels(torch, dev, log, main_res)
    kernels[0]["sass"] = {n: sass[n] for n in ("enc_4x8", "dec_8x8")}
    for kr in kernels[:2]:  # K1 and the CRC: their launches in the wire phase
        kr["wire_launches"] = {"write": wire_res["w_counts"][kr["name"]],
                               "read": wire_res["r_counts"][kr["name"]],
                               "recovery": rec_res["counts"][kr["name"]],
                               "scrub": {name: s["counts"][kr["name"]]
                                         for name, s in
                                         scr_res["steps"].items()}}
        kr["daemon_launches"] = {name: s["counts"][kr["name"]]
                                 for name, s in dmn_res["steps"].items()}
        kr["cluster_launches"] = {name: s["counts"][kr["name"]]
                                  for name, s in cls_res["steps"].items()}
        kr["clay_launches"] = {name: s["counts"][kr["name"]]
                               for name, s in clay_res["steps"].items()}
        kr["vstart_launches"] = {name: s["counts"][kr["name"]]
                                 for name, s in vs_res["steps"].items()
                                 if "counts" in s}
        kr["mesh_launches"] = {
            "write": mesh_res["w_counts"][kr["name"]],
            "read": mesh_res["r_counts"][kr["name"]],
            "digest": mesh_res["d_counts"][kr["name"]],
            "chain": mesh_res["c_counts"][kr["name"]]}
    kernels[0]["clay_pair"] = time_clay_pair(torch, dev, log, clay_res)
    kernels.append(time_gf2(torch, dev, log, bm_res))
    kernels.append(time_gf2_popcount(torch, dev, log, sh_res))
    kernels[-1]["sass"] = {n: sass[n] for n in (
        "popcount_k16", "popcount_k32", "popcount_k64", "popcount_k128")}
    kernels.append(time_gf256i(torch, dev, log, eb_res))
    kernels[-1]["sass"] = {"inter_4x8": sass["inter_4x8"]}
    kernels.append(time_mesh_digest(torch, dev, log, mesh_res))
    kernels.append(time_crush(torch, dev, log, cr_res, sass))
    kernels[-1]["placement_launches"] = pl_res["launches"]
    kernels[-1]["placement_sweep_ms"] = pl_res["sweep_ms"]
    kernels[-1]["daemon_launches"] = {
        **{name: s["counts"]["crush_rule"]
           for name, s in dmn_res["steps"].items()},
        "refresh": {r["step"]: r["k6"] for r in dmn_res["refresh"]}}
    kernels[-1]["cluster_launches"] = {
        **{name: s["counts"]["crush_rule"]
           for name, s in cls_res["steps"].items()},
        "objecter": {name: s["objecter_k6"]
                     for name, s in cls_res["steps"].items()},
        "refresh": {r["step"]: r["k6"] for r in cls_res["refresh"]}}
    kernels[-1]["vstart_launches"] = {
        **{name: s["counts"]["crush_rule"]
           for name, s in vs_res["steps"].items() if "counts" in s},
        "objecter": {name: s["objecter_k6"]
                     for name, s in vs_res["steps"].items()
                     if "objecter_k6" in s},
        "relay_command": vs_res["steps"]["relay"]["command_k6"]}
    for kr in kernels:
        log(f"{kr['name']}: {kr['ms']:.4f} ms, plain {kr['plain_ms']:.3f} "
            f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}), "
            f"launches {kr['launches']}, max_abs_err {kr['max_abs_err']}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
