"""CRC-32C of many rows at once, for the fused encode + checksum batch.

Port of ``ceph_tpu/ops/crc32c_device.py``: CRC-32C (reflected poly
0x82F63B78, init and xorout 0xFFFFFFFF) of ``rows[i, :lens[i]]``,
chained from ``inits[i]``.  On a CUDA tensor the hand-written kernel
``csrc/crc32c.cu`` runs (slicing-by-8 tables in shared memory, one
thread per row); on a CPU tensor :func:`crc32c_lanes_plain` runs, the
same slicing-by-8 update as int64 tensor ops masked to 32 bits.  Any
other device raises; so does a kernel that fails to build or launch.

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
from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("crc32c_rows")

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


def _launch_rows(base: torch.Tensor, row_stride: int, S: int,
                 offs: np.ndarray, lens: np.ndarray,
                 inits: np.ndarray) -> np.ndarray:
    """One kernel launch on the current stream over J*S rows of
    ``base``; returns the host digests u32 [J*S]."""
    dev = base.device
    J = len(offs)
    meta = torch.from_numpy(np.stack([offs, lens, inits]).astype(np.int64))
    meta = meta.to(dev, non_blocking=False)
    out = torch.empty(J * S, dtype=torch.int32, device=dev)
    err = _build.lib().crc32c_rows_launch(
        base.data_ptr(), row_stride, S, meta.data_ptr(), J, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    launches.inc()
    _build.check(err, "crc32c_rows")
    return out.cpu().numpy().view(np.uint32)


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
