"""CRC-32C of many rows at once, for the fused encode + checksum batch.

Port of ``ceph_tpu/ops/crc32c_device.py``: CRC-32C (reflected poly
0x82F63B78, init and xorout 0xFFFFFFFF) of ``rows[i, :lens[i]]``,
chained from ``inits[i]``.  On a CUDA tensor the hand-written kernel
``csrc/crc32c.cu`` runs: each row cut into 8 KiB segments, a warp per
segment and a piece per lane (slicing-by-8 tables in shared memory),
the pieces joined by the CRC combine.  On a CPU tensor
:func:`crc32c_lanes_plain` runs, the same slicing-by-8 update as int64
tensor ops masked to 32 bits.  Any other device raises; so does a kernel
that fails to build or launch.

The combine algebra the kernel rests on has its plain versions here:
:func:`crc32c_zeros`, :func:`crc32c_combine` and
:func:`crc32c_rows_segmented_plain` (segment, then combine).

Functions and signatures follow the JAX module: ``crc32c_lanes``,
``crc32c_rows`` (per-(job, shard) digests of a coalesced [S, P] batch,
read in place at each job's column offset) and ``crc32c_dev`` (one
buffer).  Digests come back as host numpy uint32: they are the 4-byte
metadata that crosses back, never the payload.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.gpu.devwatch import instrumented_launch, signature
from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("crc32c_rows")

SEGMENT = 8192  # bytes of a row per warp (csrc kSeg); a lane takes 1/32

_POLY = 0x82F63B78
_MASK = 0xFFFFFFFF


def _make_tables(n: int = 8) -> np.ndarray:
    """Slicing-by-N tables: T[0] is the byte table; T[k+1][i] advances
    T[k][i] by one more zero byte."""
    t0 = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t0 = np.where(t0 & 1, (t0 >> 1) ^ np.uint32(_POLY), t0 >> 1)
    out = np.empty((n, 256), dtype=np.uint32)
    out[0] = t0
    for k in range(1, n):
        prev = out[k - 1]
        out[k] = t0[prev & 0xFF] ^ (prev >> np.uint32(8))
    return out


_TABLES = _make_tables()

# ---------------------------------------------------------------------------
# the combine algebra (the spec the segment-parallel kernel implements)
# ---------------------------------------------------------------------------
#
# Write s for the running value inside the CRC: s0 = init ^ ~0 and the
# result is s_end ^ ~0.  s is affine in the data,
#     S(s, A || B) = Z_|B|(S(s, A)) ^ S(0, B),
# where Z_n advances a value through n zero bytes.  Z_n is linear over
# GF(2): multiplication by x^(8n) mod P in the reflected domain (bit 31
# is the coefficient of x^0), as in zlib's crc32_combine.  So a row cut
# into segments D_0 .. D_{q-1} gives
#     s_end = Z_len(s0) ^ XOR_i Z_{len after D_i}(S(0, D_i)).
# Every function here takes Python ints or int64 tensors (values in
# [0, 2^32)), through the same operators.

_ONE = 0x80000000  # x^0 in the reflected domain


def _mulmod(a, b):
    """a * b mod P, reflected; either may be an int or an int64 tensor."""
    p = a & 0
    for i in range(31, -1, -1):
        p = p ^ (b & -((a >> i) & 1))
        b = (b >> 1) ^ (_POLY & -(b & 1))
    return p


def _x2n_table(n: int = 64) -> list:
    """X2N[i] = x^(8 * 2^i) mod P: Z_{2^i} as a multiplier."""
    out = [1 << 23]  # x^8
    for _ in range(n - 1):
        out.append(_mulmod(out[-1], out[-1]))
    return out


_X2N = _x2n_table()


def _xpow8n(n: int) -> int:
    """x^(8n) mod P for an int n >= 0, by square-and-multiply."""
    p, i = _ONE, 0
    while n:
        if n & 1:
            p = _mulmod(p, _X2N[i])
        n >>= 1
        i += 1
    return p


def crc32c_zeros(s, n):
    """Z_n(s): the running value s advanced through n zero bytes.  ``n``
    is an int or an int64 tensor of byte counts (then element-wise)."""
    if not isinstance(n, torch.Tensor):
        return _mulmod(s, _xpow8n(int(n)))
    p = torch.full_like(n, _ONE)
    top = int(n.max().item()) if n.numel() else 0
    for i in range(top.bit_length()):
        p = torch.where(((n >> i) & 1).bool(), _mulmod(p, _X2N[i]), p)
    return _mulmod(p, s)


def crc32c_combine(a, b, len_b):
    """crc32c(A || B) from a = crc32c(A), b = crc32c(B) and |B| (zlib's
    crc32_combine for the Castagnoli polynomial).  The inits and xorouts
    cancel, so the rule holds for finished CRCs as for running values."""
    return crc32c_zeros(a, len_b) ^ b


def _xor_fold(t: torch.Tensor) -> torch.Tensor:
    """XOR of t [r, q] along its columns, by halving: int64 [r]."""
    while t.shape[1] > 1:
        if t.shape[1] % 2:
            t = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
        t = t[:, 0::2] ^ t[:, 1::2]
    return t[:, 0]


def crc32c_rows_segmented_plain(full: torch.Tensor, offs, lens, inits,
                                seg: int) -> np.ndarray:
    """crc32c_rows by segments and combine, as PyTorch ops on full's
    device: every (job, shard) row is cut into ``seg``-byte segments (the
    last one short), each segment's S(0, D_i) is taken on its own, and
    the row's value is Z_len(s0) ^ XOR_i Z_{len after D_i}(S(0, D_i)).
    Returns host u32 [J, S]."""
    dev = full.device
    S = int(full.shape[0])
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    J = len(offs)
    inits = _u32_host(inits, J)
    seg = int(seg)
    if seg < 1:
        raise ValueError(f"segment size must be >= 1, got {seg}")
    total = torch.zeros((J, S), dtype=torch.int64, device=dev)
    for j in range(J):
        o, ln = int(offs[j]), int(lens[j])
        q = -(-ln // seg)
        if q == 0:
            continue
        block = torch.zeros((S, q * seg), dtype=torch.uint8, device=dev)
        block[:, :ln] = full[:, o:o + ln]
        seg_len = np.full(q, seg, dtype=np.int64)
        seg_len[-1] = ln - (q - 1) * seg
        after = ln - np.arange(q, dtype=np.int64) * seg - seg_len
        # S(0, D_i): the lanes CRC from init ~0 (so s starts at 0), the
        # xorout taken off again
        part = crc32c_lanes_plain(block.reshape(S * q, seg),
                                  np.tile(seg_len, S),
                                  np.full(S * q, _MASK)) ^ _MASK
        part = crc32c_zeros(part, torch.as_tensor(np.tile(after, S),
                                                  device=dev))
        total[j] = _xor_fold(part.reshape(S, q))
    total = total.reshape(J * S)
    s0 = torch.as_tensor(np.repeat(inits, S), device=dev) ^ _MASK
    total ^= crc32c_zeros(s0, torch.as_tensor(np.repeat(lens, S),
                                              device=dev))
    return (total ^ _MASK).cpu().numpy().astype(np.uint32).reshape(J, S)


def _u32_host(values, count: int) -> np.ndarray:
    if values is None:
        return np.zeros(count, dtype=np.int64)
    return np.asarray(values, dtype=np.uint32).astype(np.int64)


def crc32c_lanes_plain(rows: torch.Tensor, lens, inits=None) -> torch.Tensor:
    """CRC-32C of ``rows[i, :lens[i]]`` chained from ``inits[i]`` as
    int64 tensor ops on rows' device; returns int64 [R] in [0, 2^32).

    The update is crc32c_device.py:84-112 step for step: one 8-byte
    slicing-by-8 step per whole word, then at most 7 tail bytes through
    the byte table."""
    dev = rows.device
    R, C = int(rows.shape[0]), int(rows.shape[1])
    T = torch.from_numpy(_TABLES.astype(np.int64)).to(dev)
    lens = torch.as_tensor(np.asarray(lens, dtype=np.int64), device=dev)
    c = torch.as_tensor(_u32_host(inits, R), device=dev) ^ _MASK
    if R == 0:
        return c
    nwords = lens // 8
    steps = int(nwords.max().item())
    if steps:
        for w in range(steps):
            b = rows[:, 8 * w:8 * w + 8].to(torch.int64)
            x = c ^ (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
                     | (b[:, 3] << 24))
            nc = (T[7][x & 0xFF] ^ T[6][(x >> 8) & 0xFF]
                  ^ T[5][(x >> 16) & 0xFF] ^ T[4][(x >> 24) & 0xFF]
                  ^ T[3][b[:, 4]] ^ T[2][b[:, 5]]
                  ^ T[1][b[:, 6]] ^ T[0][b[:, 7]])
            c = torch.where(w < nwords, nc, c)
    for t in range(8):
        pos = torch.clamp(8 * nwords + t, max=max(C - 1, 0))
        b = rows.gather(1, pos[:, None])[:, 0].to(torch.int64) if C else \
            torch.zeros_like(c)
        nc = T[0][(c ^ b) & 0xFF] ^ (c >> 8)
        c = torch.where(8 * nwords + t < lens, nc, c)
    return c ^ _MASK


def _stage_rows(dev: torch.device, S: int, offs: np.ndarray,
                lens: np.ndarray, inits: np.ndarray) -> tuple:
    """What a launch over J*S rows needs on ``dev``: the (offset,
    length, init) table, pass 1's scratch of per-segment values (the
    kernel allocates nothing) and the output."""
    J = len(offs)
    meta = torch.from_numpy(np.stack([offs, lens, inits]).astype(np.int64))
    meta = meta.to(dev, non_blocking=False)
    max_q = _build.lib().crc32c_max_segments(int(lens.max()))
    partial = torch.empty(J * S * max_q, dtype=torch.int32, device=dev)
    out = torch.empty(J * S, dtype=torch.int32, device=dev)
    return meta, partial, max_q, out


def _run_rows(base: torch.Tensor, row_stride: int, S: int,
              staged: tuple) -> torch.Tensor:
    """The two-pass kernel (segments, then the per-row combine) on the
    current stream, counted as one launch; returns the device digests
    int32 [J*S].  Allocates and synchronises nothing."""
    meta, partial, max_q, out = staged
    err = _build.lib().crc32c_rows_launch(
        base.data_ptr(), row_stride, S, meta.data_ptr(), meta.shape[1],
        partial.data_ptr(), max_q, out.data_ptr(),
        torch.cuda.current_stream(base.device).cuda_stream)
    launches.inc()
    _build.check(err, "crc32c_rows")
    return out


def _launch_rows(base: torch.Tensor, row_stride: int, S: int,
                 offs: np.ndarray, lens: np.ndarray,
                 inits: np.ndarray) -> np.ndarray:
    """The kernel over J*S rows of ``base``; host digests u32 [J*S]."""
    staged = _stage_rows(base.device, S, offs, lens, inits)
    return _run_rows(base, row_stride, S, staged).cpu().numpy().view(
        np.uint32)


def _check_rows(t: torch.Tensor, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"{what} must be uint8 2-D, got {tuple(t.shape)} "
                         f"{t.dtype}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"crc32c runs on cuda or cpu, not {t.device}")


def crc32c_lanes(rows: torch.Tensor, lens, inits=None) -> np.ndarray:
    """crc32c of ``rows[i, :lens[i]]`` for every row in one batched
    pass.  ``rows`` uint8 [R, C]; returns host u32 [R]."""
    _check_rows(rows, "rows")
    R, C = int(rows.shape[0]), int(rows.shape[1])
    lens = np.asarray(lens, dtype=np.int64)
    inits = _u32_host(inits, R)
    if lens.shape != (R,) or inits.shape != (R,):
        raise ValueError("lens and inits need one entry per row")
    if R == 0:
        return np.empty(0, dtype=np.uint32)
    if lens.min() < 0 or lens.max() > C:
        raise ValueError(f"row lengths must lie in [0, {C}]")
    return instrumented_launch(
        "crc32c_rows", signature((rows,), {}),
        lambda: _lanes(rows, lens, inits), rows.device)


def _lanes(rows: torch.Tensor, lens: np.ndarray,
           inits: np.ndarray) -> np.ndarray:
    """:func:`crc32c_lanes` after its checks."""
    R = int(rows.shape[0])
    if rows.device.type == "cpu":
        return crc32c_lanes_plain(rows, lens, inits).numpy().astype(
            np.uint32)
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    offs = np.arange(R, dtype=np.int64) * rows.stride(0)
    return _launch_rows(rows, 0, 1, offs, lens, inits)


def crc32c_rows(full: torch.Tensor, offs, lens, inits=None) -> np.ndarray:
    """Per-(job, shard) running crc32c over a coalesced plane batch.

    ``full``: uint8 [S, P] (data planes stacked over coding planes).
    ``offs``/``lens``: the J jobs' column extents in the batch; ``inits``
    one chaining value per job.  Returns host u32 [J, S]: the crc of
    shard s of job j, what each shard's HashInfo wants."""
    _check_rows(full, "full")
    S, P = int(full.shape[0]), int(full.shape[1])
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    J = len(offs)
    inits = _u32_host(inits, J)
    if lens.shape != (J,) or inits.shape != (J,):
        raise ValueError("offs, lens and inits need one entry per job")
    if J == 0:
        return np.empty((0, S), dtype=np.uint32)
    if (offs < 0).any() or (lens < 0).any() or (offs + lens > P).any():
        raise ValueError(f"job extents must lie inside the {P} columns")
    # the signature is the batch the rows are read from; the row count
    # and lengths are call data
    return instrumented_launch(
        "crc32c_rows", signature((full,), {}),
        lambda: _rows(full, offs, lens, inits), full.device)


def _rows(full: torch.Tensor, offs: np.ndarray, lens: np.ndarray,
          inits: np.ndarray) -> np.ndarray:
    """:func:`crc32c_rows` after its checks."""
    S = int(full.shape[0])
    J = len(offs)
    if full.device.type == "cpu":
        width = int(lens.max())
        rows = torch.zeros((J * S, width), dtype=torch.uint8)
        for j in range(J):
            o, ln = int(offs[j]), int(lens[j])
            rows[j * S:(j + 1) * S, :ln] = full[:, o:o + ln]
        got = crc32c_lanes_plain(rows, np.repeat(lens, S),
                                 np.repeat(inits, S).astype(np.uint32))
        return got.numpy().astype(np.uint32).reshape(J, S)
    if full.stride(1) != 1:
        full = full.contiguous()
    return _launch_rows(full, full.stride(0), S, offs, lens,
                        inits).reshape(J, S)


def crc32c_dev(data, crc: int = 0, device=None) -> int:
    """crc32c of one buffer on ``device`` (CUDA unless named); chain by
    passing the prior value."""
    dev = resolve_device(device)
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    row = torch.zeros((1, max(n, 1)), dtype=torch.uint8)
    if n:
        row[0, :n] = torch.from_numpy(arr.copy())
    return int(crc32c_lanes(row.to(dev), [n], [crc])[0])
