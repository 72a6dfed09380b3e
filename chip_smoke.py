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
11. ecbench   the device EC engine bench (``ceph_tpu_torch.tools.ecbench``)
              at its full sizes with a short calibration target: both
              engines pinned against the host oracle, the autotune over
              layout x tile x doubling variant at 16 MiB, encode and
              decode sweeps from 1 to 256 MiB, the small-stripe rates and
              the envelope; it is K2's path.

Each path zeroes the kernel launch counts just before its writes and
reads them just after, then likewise for its reads (the core phase
zeroes them before its lockdep run and reads them after its failpoint
check); each kernel of each
half must have run (for ecbench, K2 and K1: its loops capture one launch
per iteration in a CUDA graph and replay it, and the counts are of the
captured launches).  Then each kernel is timed at its path's batch
shape, beside its plain version and its bound: ``ms`` is device time per
launch from a CUDA graph of launches, ``call_ms`` the eager wrapper call
with CUDA events; the popcount row times both of shec's read shapes
(``ms`` the contribution, ``solve_ms`` the solve).  The crush phase
zeroes the counts just before its main sweep and reads them just after
(22 ``crush_rule`` launches and nothing else); the ``crush_rule`` row
times the sweep's one-attempt launch over one 2^19-id chunk (``ms``),
the exact launch over it, the eager ``compile_rule`` call, and carries
the sweep's rate, stages and the exact program's time, its bound taken
from the draws and hashes the kernel counted in this run, and the
straw2 loop's ALU-pipe issue floor (its SASS per draw, 64 lanes a cycle
per SM at the card's top SM clock).  The K1, K2,
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

    return (gf256.launches, cd.launches, gf2_matmul.launches,
            gf2_matmul.xor_launches, gf256_planes.launches,
            crush_rule.launches)


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
               threads: int = 8) -> dict:
    """Write ``nobj`` seeded objects through the stripe-batch queue's
    ``encode_crc_async`` with a 1 MiB stripe from ``threads`` threads,
    then read each back degraded with ``lost`` shards missing: through
    ``decode_data_async`` (``queue_read``) or ``codec.decode_array``.
    Every CRC and every byte is held exactly.  The launch counts are
    zeroed just before the writes and read just after them, then zeroed
    just before the reads and read just after them: each kernel in
    ``need_write`` / ``need_read`` must have run in that half, and no
    kernel in ``absent`` in either."""
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
    q = StripeBatchQueue(device=dev)
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
        reset_counts()
        w_wall = run_threads(write, nobj, threads)
        w_counts = read_counts()
        w_batches, w_jobs = q.batches, q.jobs
        batch_jobs = dict(q.batch_jobs)
        reset_counts()
        r_wall = run_threads(read, nobj, threads)
        r_counts = read_counts()
    finally:
        q.stop()
    for half, counts, need in (("write", w_counts, need_write),
                               ("read", r_counts, need_read)):
        require(all(counts[n] > 0 for n in need)
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
    return {"counts": counts, "w_counts": w_counts, "r_counts": r_counts,
            "codec": codec, "width": width, "nobj": nobj,
            "batch_jobs": batch_jobs, "survivors": survivors}


def phase_main(torch, dev, log) -> dict:
    return drive_path(torch, dev, log, "main",
                      "plugin=isa k=8 m=4 technique=reed_sol_van",
                      lost=(6, 7, 10, 11),
                      need_write=("gf256_matmul", "crc32c_rows"),
                      need_read=("gf256_matmul",), queue_read=True)


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
    phase_core(torch, dev, log)
    bm_res = phase_bitmatrix(torch, dev, log)
    sh_res = phase_shec(torch, dev, log)
    phase_lrc(torch, dev, log)
    cr_res = phase_crush(torch, dev, log)
    eb_res = phase_ecbench(torch, dev, log)
    kernels = time_kernels(torch, dev, log, main_res)
    kernels[0]["sass"] = {n: sass[n] for n in ("enc_4x8", "dec_8x8")}
    kernels.append(time_gf2(torch, dev, log, bm_res))
    kernels.append(time_gf2_popcount(torch, dev, log, sh_res))
    kernels[-1]["sass"] = {n: sass[n] for n in (
        "popcount_k16", "popcount_k32", "popcount_k64", "popcount_k128")}
    kernels.append(time_gf256i(torch, dev, log, eb_res))
    kernels[-1]["sass"] = {"inter_4x8": sass["inter_4x8"]}
    kernels.append(time_crush(torch, dev, log, cr_res, sass))
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
