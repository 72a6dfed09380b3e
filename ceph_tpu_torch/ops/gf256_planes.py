"""GF(2^8) coefficient-matrix product over packed u32 planes.

Port of the public API of ``ceph_tpu/ops/gf256_pallas.py``: the engine
bench's two layouts of the same product.

- planar ``[k, T, 128]`` -> ``[R, T, 128]`` (:func:`encode_planes`): the
  byte-plane product of ``ops/gf256.py`` over rows of T * 512 bytes, so
  on a CUDA tensor it runs K1, ``csrc/gf256.cu``'s
  ``gf256_matmul_launch`` (counted in ``gf256.launches``);
- interleaved ``[T, k, 128]`` -> ``[T, R, 128]``
  (:func:`encode_planes_interleaved`): on a CUDA tensor it runs K2,
  ``gf256_interleaved_launch``, which replaces the Pallas kernel
  ``gf256_pallas.py:192``: K1's body and operand (``gf256.k1_operand``)
  with an interleaved index, one launch per row block of the operand,
  each counted in :data:`launches`.

On a CPU tensor each entry runs the same SWAR network as int32 tensor
ops (``gf256.gf_matmul_bytes_plain`` for the planar entry); the plain
versions of both layouts (``*_plain``) run on any device, and the card
tests hold the kernels against them.  Any other device raises, and a
kernel that fails to launch raises: there is no fallback.

Words are u32 bit patterns held in int32 tensors.  The JAX contract
holds: T % tile == 0 is required, the seed is XOR'd into every loaded
word, ``donate`` exists on the planar entry only and takes effect when
R == k, and ``mul_shift`` gives the same bytes either way.  Each entry
also takes ``out=``, a tensor of the output's shape to write into (the
engine bench's timing loops reuse one output buffer).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ceph_tpu_torch.gpu.devwatch import instrumented_launch, signature
from ceph_tpu_torch.ops import _build, gf256

LANES = 128
DEFAULT_TILE = 512  # T-rows per block step: (k, 512, 128) u32 = 2 MiB for k=8

launches = _build.LaunchCount("gf256_interleaved")


def _words(t: torch.Tensor, what: str) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor (its device decides "
                        "where the product runs)")
    if t.dtype != torch.int32:
        raise ValueError(f"{what} must hold u32 words as int32, got "
                         f"{t.dtype}")
    return t


def _check(mat: np.ndarray, words3: torch.Tensor, k_axis: int, tile: int):
    """(T, k) of a planes tensor, checked against the matrix and tile."""
    if words3.dim() != 3 or words3.shape[2] != LANES:
        raise ValueError(f"planes must be 3-D with {LANES} lanes, got "
                         f"{tuple(words3.shape)}")
    k = mat.shape[1]
    if words3.shape[k_axis] != k:
        raise ValueError(f"planes carry {words3.shape[k_axis]} input rows, "
                         f"the matrix takes {k}")
    T = words3.shape[1 - k_axis]
    if tile < 1 or T % tile:
        raise ValueError(f"T={T} must be a multiple of tile={tile}")
    return T, k


def _out(out: Optional[torch.Tensor], shape, like: torch.Tensor):
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=like.device)
    out = _words(out, "out")
    if tuple(out.shape) != tuple(shape) or out.device != like.device:
        raise ValueError(f"out must be {tuple(shape)} words on "
                         f"{like.device}, got {tuple(out.shape)} on "
                         f"{out.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    return out


def encode_planes_plain(matrix, words3: torch.Tensor, seed: int = 0,
                        mul_shift: bool = False) -> torch.Tensor:
    """Planar [k, T, 128] -> [R, T, 128] as int32 tensor ops, on
    ``words3``'s device."""
    mat = gf256._as_matrix(matrix)
    w = _words(words3, "planes")
    _check(mat, w, 0, 1)
    cols = [w[j] for j in range(mat.shape[1])]
    return torch.stack(gf256.swar_network(mat, cols, seed, mul_shift))


def encode_planes_interleaved_plain(matrix, words3: torch.Tensor,
                                    seed: int = 0,
                                    mul_shift: bool = False) -> torch.Tensor:
    """Interleaved [T, k, 128] -> [T, R, 128] as int32 tensor ops, on
    ``words3``'s device."""
    mat = gf256._as_matrix(matrix)
    w = _words(words3, "planes")
    _check(mat, w, 1, 1)
    cols = [w[:, j, :] for j in range(mat.shape[1])]
    return torch.stack(gf256.swar_network(mat, cols, seed, mul_shift), dim=1)


def encode_planes(matrix, words3: torch.Tensor, seed: int = 0, *,
                  tile: int = DEFAULT_TILE, mul_shift: bool = False,
                  donate: bool = False,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the (R x k) GF(2^8) matrix to planar planes [k, T, 128].

    Returns [R, T, 128] words on ``words3``'s device.  ``donate=True``
    with R == k (a recovery matrix) writes the product over the input
    and returns it; the caller must not reuse the input afterwards."""
    mat = gf256._as_matrix(matrix)
    w = _words(words3, "planes")
    T, k = _check(mat, w, 0, tile)
    R = mat.shape[0]
    if out is not None:
        out = _out(out, (R, T, LANES), w).view(torch.uint8).reshape(R, -1)
    x = w.contiguous().view(torch.uint8).reshape(k, -1)
    res = gf256.gf_matmul_bytes(mat, x, donate=donate, seed=seed, out=out,
                                mul_shift=mul_shift)
    return res.view(torch.int32).reshape(R, T, LANES)


def encode_planes_interleaved(matrix, words3: torch.Tensor, seed: int = 0,
                              *, tile: int = DEFAULT_TILE,
                              mul_shift: bool = False,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Apply the (R x k) GF(2^8) matrix to interleaved planes
    [T, k, 128] -> [T, R, 128] words on ``words3``'s device.  ``tile``
    is checked to divide T, as the JAX entry's grid step must; the
    kernel's grid does not depend on it.  ``out`` must not overlap the
    input."""
    mat = gf256._as_matrix(matrix)
    w = _words(words3, "planes")
    T, k = _check(mat, w, 1, tile)
    R = mat.shape[0]
    out = _out(out, (T, R, LANES), w)
    if w.device.type not in ("cuda", "cpu"):
        raise ValueError(f"encode_planes_interleaved runs on cuda or cpu, "
                         f"not {w.device}")
    # a non-contiguous input runs from a contiguous copy: no overlap
    if w.device.type == "cuda" and w.is_contiguous():
        xs, os_ = w.data_ptr(), out.data_ptr()
        if xs < os_ + 4 * out.numel() and os_ < xs + 4 * w.numel():
            raise ValueError("the interleaved product cannot write over "
                             "its input")
    return instrumented_launch(
        "gf256_interleaved", signature((mat, w), {}),
        lambda: _interleaved(mat, w, seed, mul_shift, out), w.device)


def _interleaved(mat: np.ndarray, w: torch.Tensor, seed: int,
                 mul_shift: bool, out: torch.Tensor) -> torch.Tensor:
    """:func:`encode_planes_interleaved` after its checks."""
    if w.device.type == "cpu":
        out.copy_(encode_planes_interleaved_plain(mat, w, seed, mul_shift))
        return out
    T, k = w.shape[0], w.shape[1]
    R = mat.shape[0]
    op = gf256.k1_operand(mat)
    x = w.contiguous()
    xs, os_ = x.data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0, rows, masks in op.blocks:
        err = _build.lib().gf256_interleaved_launch(
            xs, os_, T, k, R, r0, rows, int(seed) & 0xFFFFFFFF,
            masks.ctypes.data, masks.nbytes, int(mul_shift), stream)
        launches.inc()
        _build.check(err, "gf256_interleaved")
    return out


def pack_planes(x: torch.Tensor) -> torch.Tensor:
    """uint8 [k, n] -> words [k, T, 128] (n % 512 == 0), a view where
    ``x`` is contiguous."""
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError(f"pack_planes takes uint8 [k, n], got "
                         f"{tuple(x.shape)} {x.dtype}")
    k, n = x.shape
    if n % (4 * LANES):
        raise ValueError(f"n={n} must be a multiple of {4 * LANES}")
    return x.contiguous().view(torch.int32).reshape(k, -1, LANES)


def unpack_planes(words3: torch.Tensor) -> torch.Tensor:
    """Words [R, T, 128] -> uint8 [R, n]."""
    w = _words(words3, "planes").contiguous()
    return w.view(torch.uint8).reshape(w.shape[0], -1)
