"""Host GF(2^w) arithmetic (numpy) — what the codecs need to build and
invert coding matrices.

Copy of the matching part of ``ceph_tpu/ec/gf.py``; the field for the
RS codes is GF(2^8) with poly x^8+x^4+x^3+x^2+1 (0x11d), the
gf-complete / ISA-L convention.  Matrix work is metadata-scale and
stays on the host; only the data planes go to the device.
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = {
    4: 0x13,
    8: 0x11D,
    16: 0x1100B,
}


@functools.lru_cache(maxsize=None)
def tables(w: int = 8):
    """(log, antilog) tables for GF(2^w).  antilog has length
    2*(2^w - 1) + 1 so ``antilog[log[a] + log[b]]`` needs no reduction;
    log[0] is a sentinel callers branch around."""
    if w not in GF_POLY:
        raise ValueError(f"unsupported w={w} for table generation")
    n = (1 << w) - 1
    poly = GF_POLY[w]
    log = np.zeros(1 << w, dtype=np.int32)
    antilog = np.zeros(2 * n + 1, dtype=np.int64 if w > 8 else np.int32)
    x = 1
    for i in range(n):
        antilog[i] = x
        antilog[i + n] = x
        log[x] = i
        x <<= 1
        if x & (1 << w):
            x ^= poly
    log[0] = 2 * n
    return log, antilog.astype(np.uint32)


def mul(a, b, w: int = 8):
    """Element-wise GF(2^w) multiply of uint arrays (or scalars)."""
    log, antilog = tables(w)
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    out = antilog[(log[a] + log[b]) % (2 * ((1 << w) - 1))]
    out = np.where((a == 0) | (b == 0), 0, out)
    return out.astype(np.uint32)


def inv(a, w: int = 8):
    """Element-wise multiplicative inverse (inv(0) raises)."""
    log, antilog = tables(w)
    a = np.asarray(a, dtype=np.uint32)
    if np.any(a == 0):
        raise ZeroDivisionError("gf.inv(0)")
    n = (1 << w) - 1
    return antilog[(n - log[a]) % n].astype(np.uint32)


def mat_inv(A: np.ndarray, w: int = 8) -> np.ndarray:
    """Invert a square GF(2^w) matrix by Gauss-Jordan elimination;
    raises ValueError on singular input."""
    A = np.array(A, dtype=np.uint32)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError("mat_inv needs a square matrix")
    aug = np.concatenate([A, np.eye(n, dtype=np.uint32)], axis=1)
    for col in range(n):
        pivot = col + int(np.argmax(aug[col:, col] != 0))
        if aug[pivot, col] == 0:
            raise ValueError("singular matrix over GF(2^%d)" % w)
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = mul(aug[col], inv(aug[col, col], w), w)
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= mul(aug[row, col], aug[col], w)
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=None)
def _const_bitmatrix(c: int, w: int) -> np.ndarray:
    B = np.zeros((w, w), dtype=np.uint8)
    elt = c
    for x in range(w):
        for bit in range(w):
            B[bit, x] = (elt >> bit) & 1
        elt = int(mul(elt, 2, w))
    B.setflags(write=False)  # shared across callers
    return B


def const_to_bitmatrix(c: int, w: int = 8) -> np.ndarray:
    """w x w GF(2) matrix B with B[l, x] = bit l of (c * 2^x)."""
    return _const_bitmatrix(int(c), int(w))


def matrix_to_bitmatrix(M: np.ndarray, w: int = 8) -> np.ndarray:
    """Expand an (r x c) GF(2^w) matrix into the (r*w x c*w) GF(2)
    matrix whose block (i, j) is const_to_bitmatrix(M[i, j]) — the
    jerasure_matrix_to_bitmatrix layout."""
    M = np.asarray(M)
    r, c = M.shape
    out = np.zeros((r * w, c * w), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            out[i * w:(i + 1) * w, j * w:(j + 1) * w] = const_to_bitmatrix(
                int(M[i, j]), w)
    return out
