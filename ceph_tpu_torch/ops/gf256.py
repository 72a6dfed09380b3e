"""GF(2^8) coefficient-matrix product over byte planes.

Port of ``ceph_tpu/ops/gf256_swar.py:157`` (``gf_matmul_bytes``) and the
Pallas kernel it reaches, ``ceph_tpu/ops/gf256_pallas.py:81``.  On a CUDA
tensor the product runs the hand-written kernel ``csrc/gf256.cu``; on a
CPU tensor it runs :func:`gf_matmul_bytes_plain`, the same SWAR network
written as int32 PyTorch ops.  Any other device raises, and a kernel that
fails to build or launch raises: there is no fallback.

Contract (the JAX one): an (R x k) uint8 coefficient matrix applied to
uint8 planes [k, n] gives uint8 [R, n], for any n (padded to a whole
number of 4-byte words internally).  ``seed`` is XOR'd into every loaded
word, as the Pallas kernel's seed operand is.  ``donate=True`` with
R == k lets the product overwrite its input and return it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("gf256_matmul")

_LOW7 = 0x7F7F7F7F
_ONES = 0x01010101
_RED = 0x1D  # poly 0x11d reduction byte
MAX_DIM = 32  # the kernel's row and column limit (csrc/gf256.cu kMaxDim)


def _as_matrix(matrix) -> np.ndarray:
    mat = np.ascontiguousarray(np.asarray(matrix), dtype=np.uint8)
    if mat.ndim != 2:
        raise ValueError(f"coefficient matrix must be 2-D, got {mat.shape}")
    return mat


def _check_planes(x: torch.Tensor, k: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError("planes must be a torch.Tensor (its device decides "
                        "where the product runs)")
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[0] != k:
        raise ValueError(f"planes must be uint8 [{k}, n], got "
                         f"{tuple(x.shape)} {x.dtype}")


def _double(v: torch.Tensor) -> torch.Tensor:
    """Multiply every packed byte of int32 words by x in GF(2^8).  The
    arithmetic shift of int32 is masked right after it, and every
    constant stays below 2^31 so nothing promotes to int64."""
    carry = (v >> 7) & _ONES
    return ((v & _LOW7) << 1) ^ (carry * _RED)


def _seed_i32(seed: int) -> int:
    seed = int(seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= 1 << 31 else seed


def gf_matmul_bytes_plain(matrix, x: torch.Tensor,
                          seed: int = 0) -> torch.Tensor:
    """The SWAR network of gf256_swar.py:75-102 as int32 tensor ops on
    ``x.view(torch.int32)``; runs on whatever device ``x`` lies on."""
    mat = _as_matrix(matrix)
    R, k = mat.shape
    _check_planes(x, k)
    n = x.shape[1]
    pad = (-n) % 4
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()
    words = xp.view(torch.int32)
    s = _seed_i32(seed)
    need = np.bitwise_or.reduce(mat.astype(np.int64), axis=0)
    acc = [None] * R
    for j in range(k):
        p = words[j] ^ s
        for b in range(max(int(need[j]).bit_length(), 1)):
            if b > 0:
                p = _double(p)
            for i in range(R):
                if (int(mat[i, j]) >> b) & 1:
                    acc[i] = p if acc[i] is None else acc[i] ^ p
    zero = torch.zeros_like(words[0])
    out = torch.stack([a if a is not None else zero for a in acc])
    out = out.contiguous().view(torch.uint8)
    return out[:, :n] if pad else out


def _row_pitch_ok(t: torch.Tensor) -> bool:
    return (t.stride(1) == 1 and t.stride(0) % 4 == 0
            and t.data_ptr() % 4 == 0)


def _launch(mat: np.ndarray, x: torch.Tensor, out: torch.Tensor,
            seed: int) -> None:
    """One kernel launch on the current stream: x [k, 4W] -> out [R, 4W],
    both with 4-byte-aligned rows of unit column stride."""
    R, k = mat.shape
    words = x.shape[1] // 4
    err = _build.lib().gf256_matmul_launch(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), words,
        k, R, int(seed) & 0xFFFFFFFF, mat.ctypes.data,
        torch.cuda.current_stream(x.device).cuda_stream)
    launches.inc()
    _build.check(err, "gf256_matmul")


def gf_matmul_bytes(matrix, x: torch.Tensor, donate: bool = False,
                    seed: int = 0,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the (R x k) GF(2^8) matrix to byte planes x [k, n].

    Returns uint8 [R, n] on x's device.  ``out``, when given, is a
    uint8 [R, n] tensor (a row block of a larger batch is fine) the
    product is written into and returned.  ``donate=True`` with R == k
    writes the product over ``x`` itself."""
    mat = _as_matrix(matrix)
    R, k = mat.shape
    _check_planes(x, k)
    n = x.shape[1]
    if donate and R == k and out is None:
        out = x
    if out is not None and (out.dtype != torch.uint8
                            or tuple(out.shape) != (R, n)
                            or out.device != x.device):
        raise ValueError(f"out must be uint8 [{R}, {n}] on {x.device}")
    if x.device.type == "cpu":
        res = gf_matmul_bytes_plain(mat, x, seed)
        if out is None:
            return res
        out.copy_(res)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"gf_matmul_bytes runs on cuda or cpu, not "
                         f"{x.device}")
    if k > MAX_DIM or R > MAX_DIM:
        raise ValueError(f"gf256 kernel takes k, R <= {MAX_DIM}, got "
                         f"{R}x{k}")
    if n % 4 == 0 and _row_pitch_ok(x) and (out is None
                                            or _row_pitch_ok(out)):
        if out is None:
            out = torch.empty((R, n), dtype=torch.uint8, device=x.device)
        _launch(mat, x, out, seed)
        return out
    # ragged width or unaligned rows: run on a word-padded copy
    words = -(-n // 4)
    xp = torch.zeros((k, 4 * words), dtype=torch.uint8, device=x.device)
    xp[:, :n] = x
    op = torch.empty((R, 4 * words), dtype=torch.uint8, device=x.device)
    _launch(mat, xp, op, seed)
    if out is None:
        return op[:, :n]
    out.copy_(op[:, :n])
    return out
