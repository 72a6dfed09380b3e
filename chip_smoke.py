#!/usr/bin/env python3
"""Drive the port's erasure-coded data path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build   the CUDA kernels from ``ceph_tpu_torch/csrc`` (``sm_90a``)
           into ``ceph_tpu_torch/_build/``;
2. gf256   the GF(2^8) product kernel against its plain PyTorch version
           on the card, bit for bit: (R, k) in {(4, 8), (2, 4), (3, 3),
           (8, 8) recovery}, ragged widths, a nonzero seed, donation,
           a row-slice output, one full-width 8 x 1 Mi batch;
3. crc32c  the row CRC-32C kernel against its plain version: lengths
           0..4096 and 512 KiB, unaligned rows, chained inits,
           multi-job ``crc32c_rows`` at column offsets;
4. main    ``isa reed_sol_van k=8 m=4`` with a 1 MiB stripe (chunk 128
           KiB): 256 seeded 4 MiB objects (1 GiB) written from 8 threads
           through ``StripeBatchQueue.encode_crc_async`` (every CRC held
           against the plain CRC of the stored shard), then read back
           degraded through ``decode_data_async`` with shards 6, 7, 10,
           11 lost, byte for byte.  Kernel launch counts are zeroed just
           before and read just after; each kernel must have run.

Then each kernel is timed with CUDA events at the main path's shapes,
beside its plain version and its bound.  Output, every number beside the
card's name and power limit: one line per phase, then the kernel table
as one JSON line, then the card line from nvidia-smi, then the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32 rate, used for int32 ops
SEED = 20261016
MiB = 1 << 20


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


def gf_ops(mat: np.ndarray, words: int) -> int:
    """Integer ops of the SWAR product: per word column, one seed XOR
    per input row, six ops per doubling, one XOR per set coefficient
    bit."""
    need = np.bitwise_or.reduce(mat.astype(np.int64), axis=0)
    per = sum(1 + 6 * (max(int(c).bit_length(), 1) - 1) for c in need)
    per += int(np.unpackbits(mat.astype(np.uint8)).sum())
    return per * words


def bound(nbytes: int, ops: int):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


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
    torch.cuda.synchronize()
    log(f"gf256: {checked + 2} kernel calls bit-equal to the plain version")


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
    torch.cuda.synchronize()
    log("crc32c: lanes 0..4096 (aligned, unaligned), 24 x 512 KiB, chained "
        "inits, 4-job crc32c_rows bit-equal to the plain version")


def phase_main(torch, dev, log, nobj: int = 256, obj_bytes: int = 4 * MiB,
               threads: int = 8) -> dict:
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue
    from ceph_tpu_torch.ops import crc32c_device as cd
    from ceph_tpu_torch.ops import gf256
    from ceph_tpu_torch.osd.ecutil import StripeInfo

    codec = codec_from_profile(
        "plugin=isa k=8 m=4 technique=reed_sol_van", device=dev)
    k, m = codec.k, codec.m
    si = StripeInfo(k, codec.get_chunk_size(1 * MiB))
    require(si.chunk_size == 128 << 10, "1 MiB stripe -> 128 KiB chunks")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    objs = torch.randint(0, 256, (nobj, obj_bytes), dtype=torch.uint8,
                         device=dev, generator=g).cpu().numpy()
    planes = [si.interleave(memoryview(objs[i]))[0] for i in range(nobj)]
    q = StripeBatchQueue(device=dev)
    coding = [None] * nobj
    crcs = [None] * nobj
    decoded = [None] * nobj
    survivors = [0, 1, 2, 3, 4, 5, 8, 9]

    def run(fn):
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

    def write(i):
        coding[i], crcs[i] = q.encode_crc_async(
            codec, planes[i], size=obj_bytes).result()

    def read(i):
        avail = {s: planes[i][s] if s < k else coding[i][s - k]
                 for s in survivors}
        decoded[i] = q.decode_data_async(codec, avail).result()

    gf256.launches.reset()
    cd.launches.reset()
    try:
        w_wall = run(write)
        w_batches, w_jobs = q.batches, q.jobs
        r_wall = run(read)
    finally:
        q.stop()
    counts = {"gf256_matmul": gf256.launches.value,
              "crc32c_rows": cd.launches.value}
    require(all(v > 0 for v in counts.values()),
            f"every kernel ran on the main path: {counts}")

    # every returned CRC against the plain CRC of the stored shard
    width = planes[0].shape[1]
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
            "every write's CRCs equal the plain CRC of its stored shards")
    for i in range(nobj):
        require(si.deinterleave(decoded[i], obj_bytes) == objs[i].tobytes(),
                f"degraded read of object {i} returns what was written")
    logical = nobj * obj_bytes
    r_batches = q.batches - w_batches
    r_jobs = q.jobs - w_jobs
    log(f"main: wrote {nobj} x {obj_bytes >> 20} MiB from {threads} "
        f"threads in {w_wall:.3f} s = {logical / w_wall / 1e9:.3f} GB/s "
        f"encode+crc, {w_jobs} jobs in {w_batches} batches (mean width "
        f"{w_jobs / w_batches:.2f}); degraded read in {r_wall:.3f} s = "
        f"{logical / r_wall / 1e9:.3f} GB/s, {r_jobs} jobs in {r_batches} "
        f"batches (mean width {r_jobs / r_batches:.2f}); CRCs and bytes "
        f"exact; launches {counts}")
    return {"counts": counts, "codec": codec, "batch_cols": 2 * width,
            "survivors": survivors}


def time_kernels(torch, dev, log, main: dict) -> list:
    from ceph_tpu_torch.ops import crc32c_device as cd
    from ceph_tpu_torch.ops import gf256

    codec = main["codec"]
    k, m = codec.k, codec.m
    P = main["batch_cols"]
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    nbuf = 8  # rotate buffers: the set exceeds the 50 MB L2
    bufs = [torch.randint(0, 256, (k + m, P), dtype=torch.uint8, device=dev,
                          generator=g) for _ in range(nbuf)]
    mat = codec.coding_u8
    it = iter(range(1 << 30))

    def enc():
        b = bufs[next(it) % nbuf]
        gf256.gf_matmul_bytes(mat, b[:k], out=b[k:])

    gf_ms = event_ms(torch, enc, 40)
    x = bufs[0][:k]
    ref = gf256.gf_matmul_bytes_plain(mat, x)
    got = gf256.gf_matmul_bytes(mat, x)
    gf_err = int((got.int() - ref.int()).abs().max().item())
    gf_plain_ms = event_ms(torch, lambda: gf256.gf_matmul_bytes_plain(mat, x),
                           5, warmup=1)
    gf_bound, gf_by = bound((k + m) * P, gf_ops(mat, P // 4))

    rec, _ = codec.recovery_matrix(main["survivors"])
    dec_ms = event_ms(torch, lambda: gf256.gf_matmul_bytes(
        rec, bufs[next(it) % nbuf][:k], donate=True), 40)
    dec_bound, _ = bound(2 * k * P, gf_ops(rec, P // 4))
    log(f"gf256 decode 8x8 donated [8, {P}]: {dec_ms:.4f} ms "
        f"(bound {dec_bound:.4f} ms)")

    half = P // 2
    offs, lens = [0, half], [half, half]

    def crc():
        cd.crc32c_rows(bufs[next(it) % nbuf], offs, lens)

    crc_ms = event_ms(torch, crc, 10)
    got = cd.crc32c_rows(bufs[0], offs, lens).astype(np.int64)
    t0 = time.monotonic()
    want = rows_plain(torch, bufs[0], offs, lens, [0, 0]).astype(np.int64)
    torch.cuda.synchronize()
    crc_plain_ms = (time.monotonic() - t0) * 1e3
    crc_err = int(np.abs(got - want).max())
    crc_bound, crc_by = bound(2 * (k + m) * half + 4 * 2 * (k + m),
                              2 * (k + m) * half // 8 * 22)
    return [
        {"name": "gf256_matmul", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf256.cu",
         "replaces": "ceph_tpu/ops/gf256_pallas.py:81",
         "launches": main["counts"]["gf256_matmul"], "max_abs_err": gf_err,
         "ms": gf_ms, "plain_ms": gf_plain_ms, "bound_ms": gf_bound,
         "bound_by": gf_by, "library_ms": None},
        {"name": "crc32c_rows", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crc32c.cu",
         "replaces": "ceph_tpu/ops/crc32c_device.py:75",
         "launches": main["counts"]["crc32c_rows"], "max_abs_err": crc_err,
         "ms": crc_ms, "plain_ms": crc_plain_ms, "bound_ms": crc_bound,
         "bound_by": crc_by, "library_ms": None},
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
    phase_gf256(torch, dev, log)
    phase_crc(torch, dev, log)
    main_res = phase_main(torch, dev, log)
    kernels = time_kernels(torch, dev, log, main_res)
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
