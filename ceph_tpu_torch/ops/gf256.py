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

The kernel consumes the matrix as :class:`K1Operand`, its coefficient
bits expanded into 0/~0 word masks (``k1_operand``, cached by the
matrix's bytes); :func:`operand_network` is the kernel's own network
over that operand as PyTorch ops, which the tests hold against
:func:`swar_network` and the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ceph_tpu_torch.gpu.devwatch import instrumented_launch, signature
from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("gf256_matmul")

_LOW7 = 0x7F7F7F7F
_ONES = 0x01010101
_RED = 0x1D  # poly 0x11d reduction byte
MAX_DIM = 32  # the kernel's row and column limit (csrc/gf256.cu kMaxDim)
ROW_BLOCK = 16  # rows per launch when R and k both exceed it (kRowBlock)
_OPERAND_CACHE_MAX = 4096
_operands: dict = {}


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


def _double(v: torch.Tensor, mul_shift: bool = False) -> torch.Tensor:
    """Multiply every packed byte of int32 words by x in GF(2^8).  The
    arithmetic shift of int32 is masked right after it, and every
    constant stays below 2^31 so nothing promotes to int64.
    ``mul_shift`` writes the reduction ``carry * 0x1D`` as the shift-XOR
    chain (0x1D = bits 0, 2, 3, 4), as gf256_pallas.py:63 does; the bytes
    are the same."""
    carry = (v >> 7) & _ONES
    if mul_shift:
        red = carry ^ (carry << 2) ^ (carry << 3) ^ (carry << 4)
    else:
        red = carry * _RED
    return ((v & _LOW7) << 1) ^ red


def _seed_i32(seed: int) -> int:
    seed = int(seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= 1 << 31 else seed


def swar_network(mat: np.ndarray, cols, seed: int = 0,
                 mul_shift: bool = False) -> list:
    """The SWAR network of gf256_swar.py:75-102 (and of the Pallas
    kernels) as int32 tensor ops: ``cols[j]`` holds input column j's
    words; returns the R output tensors, each of ``cols[0]``'s shape."""
    R, k = mat.shape
    s = _seed_i32(seed)
    need = np.bitwise_or.reduce(mat.astype(np.int64), axis=0)
    acc = [None] * R
    for j in range(k):
        p = cols[j] ^ s
        for b in range(max(int(need[j]).bit_length(), 1)):
            if b > 0:
                p = _double(p, mul_shift)
            for i in range(R):
                if (int(mat[i, j]) >> b) & 1:
                    acc[i] = p if acc[i] is None else acc[i] ^ p
    return [a if a is not None else torch.zeros_like(cols[0]) for a in acc]


def gf_matmul_bytes_plain(matrix, x: torch.Tensor,
                          seed: int = 0) -> torch.Tensor:
    """The SWAR network over ``x.view(torch.int32)``; runs on whatever
    device ``x`` lies on."""
    mat = _as_matrix(matrix)
    R, k = mat.shape
    _check_planes(x, k)
    n = x.shape[1]
    pad = (-n) % 4
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()
    words = xp.view(torch.int32)
    out = torch.stack(swar_network(mat, [words[j] for j in range(k)], seed))
    out = out.contiguous().view(torch.uint8)
    return out[:, :n] if pad else out


def bucket(n: int) -> int:
    """The kernel's row or column bucket (csrc/gf256.cu bucket)."""
    return 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32


class K1Operand:
    """A coefficient matrix as K1 and K2 consume it.  ``blocks`` holds one
    (first row, rows, masks) per launch: masks u32 [bucket(rows), 8,
    bucket(k)] with ``masks[i, s, j]`` = 0xFFFFFFFF when bit 7 - s of
    ``matrix[first + i, j]`` is set, else 0 (zero past the matrix).  A
    matrix with more than ``ROW_BLOCK`` rows and columns is split into
    row blocks of ``ROW_BLOCK``: its masks would not fit the kernel's
    parameter space."""

    __slots__ = ("k", "blocks")

    def __init__(self, mat: np.ndarray) -> None:
        R, k = mat.shape
        self.k = k
        step = ROW_BLOCK if R > ROW_BLOCK and k > ROW_BLOCK else R
        shifts = np.arange(7, -1, -1, dtype=np.uint8)
        self.blocks = []
        for r0 in range(0, R, step):
            rows = min(step, R - r0)
            bits = (mat[r0:r0 + rows, None, :] >> shifts[None, :, None]) & 1
            masks = np.zeros((bucket(rows), 8, bucket(k)), dtype=np.uint32)
            masks[:rows, :, :k] = bits.astype(np.uint32) * np.uint32(
                0xFFFFFFFF)
            self.blocks.append((r0, rows, masks))


def k1_operand(matrix) -> K1Operand:
    """The kernel operand of ``matrix``, expanded once per distinct
    matrix: the encode matrix is fixed per codec and each recovery matrix
    per survivor signature, so an eager call pays a dict lookup."""
    mat = _as_matrix(matrix)
    if mat.shape[0] > MAX_DIM or mat.shape[1] > MAX_DIM:
        raise ValueError(f"gf256 kernel takes k, R <= {MAX_DIM}, got "
                         f"{mat.shape[0]}x{mat.shape[1]}")
    key = (mat.shape, mat.tobytes())
    op = _operands.get(key)
    if op is None:
        if len(_operands) >= _OPERAND_CACHE_MAX:
            _operands.clear()
        op = _operands[key] = K1Operand(mat)
    return op


def operand_network(op: K1Operand, cols, seed: int = 0,
                    mul_shift: bool = False) -> list:
    """K1's network over its operand as int32 tensor ops (Horner over the
    coefficient bits, one output row at a time, every mask applied with
    an AND): ``cols[j]`` holds input column j's words; returns the R
    output tensors.  The tests hold it against :func:`swar_network`."""
    s = _seed_i32(seed)
    xs = [c ^ s for c in cols]
    outs = []
    for _r0, rows, masks in op.blocks:
        signed = masks.view(np.int32)
        for i in range(rows):
            t = torch.zeros_like(xs[0])
            for step in range(8):
                if step:
                    t = _double(t, mul_shift)
                for j in range(op.k):
                    t = t ^ (xs[j] & int(signed[i, step, j]))
            outs.append(t)
    return outs


def _row_pitch_ok(t: torch.Tensor) -> bool:
    return (t.stride(1) == 1 and t.stride(0) % 4 == 0
            and t.data_ptr() % 4 == 0)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    sa, sb = a.data_ptr(), b.data_ptr()
    ea = sa + (a.shape[0] - 1) * a.stride(0) + a.shape[1]
    eb = sb + (b.shape[0] - 1) * b.stride(0) + b.shape[1]
    return sa < eb and sb < ea


def _launch(op: K1Operand, x: torch.Tensor, out: torch.Tensor,
            seed: int, mul_shift: bool = False) -> None:
    """One kernel launch per row block, on the current stream: x [k, 4W]
    -> out [R, 4W], both with 4-byte-aligned rows of unit column stride.
    A split matrix writing over its own input goes through a scratch
    output: its second row block reads rows the first one wrote."""
    if len(op.blocks) > 1 and _overlap(x, out):
        tmp = torch.empty_like(out)
        _launch(op, x, tmp, seed, mul_shift)
        out.copy_(tmp)
        return
    words = x.shape[1] // 4
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0, rows, masks in op.blocks:
        o = out[r0:r0 + rows]
        err = _build.lib().gf256_matmul_launch(
            x.data_ptr(), x.stride(0), o.data_ptr(), o.stride(0), words,
            op.k, rows, int(seed) & 0xFFFFFFFF, masks.ctypes.data,
            masks.nbytes, int(mul_shift), stream)
        launches.inc()
        _build.check(err, "gf256_matmul")


def gf_matmul_bytes(matrix, x: torch.Tensor, donate: bool = False,
                    seed: int = 0,
                    out: Optional[torch.Tensor] = None,
                    mul_shift: bool = False) -> torch.Tensor:
    """Apply the (R x k) GF(2^8) matrix to byte planes x [k, n].

    Returns uint8 [R, n] on x's device.  ``out``, when given, is a
    uint8 [R, n] tensor (a row block of a larger batch is fine) the
    product is written into and returned.  ``donate=True`` with R == k
    writes the product over ``x`` itself.  ``mul_shift`` picks the
    kernel's doubling variant (the engine bench tunes it); the bytes
    are the same."""
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
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gf_matmul_bytes runs on cuda or cpu, not "
                         f"{x.device}")
    return instrumented_launch(
        "gf256_matmul", signature((mat, x), {}),
        lambda: _product(mat, x, seed, out, mul_shift), x.device)


def _product(mat: np.ndarray, x: torch.Tensor, seed: int,
             out: Optional[torch.Tensor], mul_shift: bool) -> torch.Tensor:
    """:func:`gf_matmul_bytes` after its checks: the plain version on
    the CPU, the kernel on the card."""
    R, k = mat.shape
    n = x.shape[1]
    if x.device.type == "cpu":
        res = gf_matmul_bytes_plain(mat, x, seed)
        if out is None:
            return res
        out.copy_(res)
        return out
    op = k1_operand(mat)
    if n % 4 == 0 and _row_pitch_ok(x) and (out is None
                                            or _row_pitch_ok(out)):
        if out is None:
            out = torch.empty((R, n), dtype=torch.uint8, device=x.device)
        _launch(op, x, out, seed, mul_shift)
        return out
    # ragged width or unaligned rows: run on a word-padded copy
    words = -(-n // 4)
    xp = torch.zeros((k, 4 * words), dtype=torch.uint8, device=x.device)
    xp[:, :n] = x
    po = torch.empty((R, 4 * words), dtype=torch.uint8, device=x.device)
    _launch(op, xp, po, seed, mul_shift)
    if out is None:
        return po[:, :n]
    out.copy_(po[:, :n])
    return out
