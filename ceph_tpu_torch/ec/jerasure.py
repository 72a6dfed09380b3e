"""jerasure-equivalent plugin: the seven techniques on the port's engines.

Port of ``ceph_tpu/ec/jerasure.py`` (reference: src/erasure-code/
jerasure/ErasureCodeJerasure.h:82-247, factory dispatch in
ErasureCodePluginJerasure.cc):

- reed_sol_van     : Vandermonde RS over GF(2^8) (``RSMatrixCodec``)
- reed_sol_r6_op   : RAID-6 optimized RS (ones row + powers of 2)
- cauchy_orig      : Cauchy matrix expanded to a bit-matrix
- cauchy_good      : density-optimized Cauchy bit-matrix
- liberation       : minimal-density RAID-6 bit-matrix (w prime >= k)
- blaum_roth       : MDS array code, w+1 prime
- liber8tion       : w=8 RAID-6 bit-matrix

The bit-matrix techniques run as packet XOR-matmuls (``BitmatrixCodec``
on the GF(2) kernel).  The liberation, blaum_roth and liber8tion
matrices are the reference package's constructions, copied; the tests
hold every generator bit-matrix equal to it.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec import gf, matrices
from ceph_tpu_torch.ec.codec import BitmatrixCodec, RSMatrixCodec
from ceph_tpu_torch.ec.interface import ErasureCodeError, to_int

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % p for p in range(2, int(n**0.5) + 1))


def _gf2_invertible(M: np.ndarray) -> bool:
    M = np.array(M, dtype=np.uint8) & 1
    n = M.shape[0]
    for col in range(n):
        nz = np.nonzero(M[col:, col])[0]
        if len(nz) == 0:
            return False
        p = col + int(nz[0])
        if p != col:
            M[[col, p]] = M[[p, col]]
        rows = np.nonzero(M[:, col])[0]
        rows = rows[rows != col]
        M[rows] ^= M[col]
    return True


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Minimal-density RAID-6 bit-matrix in the Liberation-code family.

    P parity XORs all data (identity blocks); Q parity applies X_0 = I
    and, for j >= 1, X_j = (cyclic shift by j) plus one extra bit, placed
    by a deterministic backtracking search against the RAID-6 MDS
    conditions (every X_j and every X_a ^ X_b invertible over GF(2))."""
    if not _is_prime(w) or k > w:
        raise ErasureCodeError("liberation needs prime w >= k")
    eye = np.eye(w, dtype=np.uint8)
    xs: list = [eye]

    def compatible(cand: np.ndarray) -> bool:
        return _gf2_invertible(cand) and all(
            _gf2_invertible(cand ^ x) for x in xs)

    def search(j: int) -> bool:
        if j == k:
            return True
        rot = np.roll(eye, j, axis=0)
        # start at the classic liberation extra-bit row
        r0 = (j * ((w - 1) // 2)) % w
        for dr in range(w):
            r = (r0 + dr) % w
            for dc in range(w):
                cand = rot.copy()
                cand[r, (r + j - 1 + dc) % w] ^= 1
                if compatible(cand):
                    xs.append(cand)
                    if search(j + 1):
                        return True
                    xs.pop()
        return False

    if not search(1):
        raise ErasureCodeError(
            f"liberation construction failed for k={k} w={w}")
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        bm[0:w, j * w:(j + 1) * w] = eye
        bm[w:2 * w, j * w:(j + 1) * w] = xs[j]
    return bm


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth MDS array code for m=2 (w+1 prime, k <= w): the second
    parity multiplies chunk j by x^j in GF(2)[x]/(M_p(x)),
    M_p(x) = (x^p - 1)/(x - 1), p = w + 1."""
    if not _is_prime(w + 1) or k > w:
        raise ErasureCodeError("blaum_roth needs w+1 prime and k <= w")
    p = w + 1

    def mul_xj(j: int) -> np.ndarray:
        # x^(col + j) reduced, where x^w = 1 + x + ... + x^(w-1)
        M = np.zeros((w, w), dtype=np.uint8)
        for col in range(w):
            e = (col + j) % p
            if e < w:
                M[e, col] = 1
            else:
                M[:, col] = 1
        return M

    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        bm[0:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:2 * w, j * w:(j + 1) * w] = mul_xj(j)
    return bm


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """w=8 RAID-6 code (m=2, k <= 8): Q applies the GF(2^8) companion
    matrix of 2^j to chunk j, invertible and pairwise distinct, so the
    code is MDS."""
    w = 8
    if k > w:
        raise ErasureCodeError("liber8tion needs k <= 8")
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        bm[0:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:2 * w, j * w:(j + 1) * w] = gf.const_to_bitmatrix(
            gf.pow_(2, j, 8), 8)
    return bm


class ErasureCodeJerasure:
    """Factory facade: pick the technique, return a configured codec."""

    TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                  "cauchy_good", "liberation", "blaum_roth", "liber8tion")

    @staticmethod
    def create(profile: dict, device=None) -> "RSMatrixCodec | BitmatrixCodec":
        technique = profile.get("technique", "reed_sol_van")
        k = to_int(profile, "k", DEFAULT_K)
        m = to_int(profile, "m", DEFAULT_M)
        w = to_int(profile, "w", DEFAULT_W)
        if k < 2:
            raise ErasureCodeError("k must be >= 2")
        if technique == "reed_sol_van":
            if w != 8:
                raise ErasureCodeError("reed_sol_van currently supports w=8")
            codec = RSMatrixCodec(k, m, matrices.jerasure_rs_vandermonde(k, m),
                                  device=device)
        elif technique == "reed_sol_r6_op":
            if m != 2:
                raise ErasureCodeError("reed_sol_r6_op requires m=2")
            codec = RSMatrixCodec(k, 2, matrices.jerasure_rs_r6(k),
                                  device=device)
        elif technique in ("cauchy_orig", "cauchy_good"):
            build = (matrices.cauchy_original if technique == "cauchy_orig"
                     else matrices.cauchy_good)
            codec = BitmatrixCodec(
                k, m, w, gf.matrix_to_bitmatrix(build(k, m, w), w),
                device=device)
        elif technique in ("liberation", "blaum_roth", "liber8tion"):
            if m != 2:
                raise ErasureCodeError(f"{technique} requires m=2")
            if technique == "liberation":
                codec = BitmatrixCodec(k, 2, w, liberation_bitmatrix(k, w),
                                       device=device)
            elif technique == "blaum_roth":
                codec = BitmatrixCodec(k, 2, w, blaum_roth_bitmatrix(k, w),
                                       device=device)
            else:
                codec = BitmatrixCodec(k, 2, 8, liber8tion_bitmatrix(k),
                                       device=device)
        else:
            raise ErasureCodeError(f"unknown technique {technique!r}")
        codec.init(profile)
        return codec
