"""Reed-Solomon generator-matrix constructions (host, numpy).

Copy of the RS constructions of ``ceph_tpu/ec/matrices.py``; the
tests hold every matrix byte-identical to it.

- ``isa_rs_vandermonde`` / ``isa_cauchy``: ISA-L's gf_gen_rs_matrix /
  gf_gen_cauchy1_matrix (reference: src/erasure-code/isa/
  ErasureCodeIsa.cc:380-388).
- ``jerasure_rs_vandermonde``: jerasure's reed_sol_van, the extended
  Vandermonde matrix reduced to systematic form.
- ``jerasure_rs_r6``: reed_sol_r6_op (ones row + powers of 2).

Each returns the (m x k) coding block; encode puts these m parity rows
under an implicit k x k identity (systematic code).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec import gf


def isa_rs_vandermonde(k: int, m: int, w: int = 8) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix coding block: row i = powers of 2^i."""
    coding = np.zeros((m, k), dtype=np.uint32)
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            coding[i, j] = p
            p = int(gf.mul(p, gen, w))
        gen = int(gf.mul(gen, 2, w))
    return coding


def isa_cauchy(k: int, m: int, w: int = 8) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix coding block: entry inv(i XOR j) for
    rows i in [k, k+m), columns j in [0, k)."""
    coding = np.zeros((m, k), dtype=np.uint32)
    for i in range(k, k + m):
        for j in range(k):
            coding[i - k, j] = int(gf.inv(i ^ j, w))
    return coding


def _extended_vandermonde(rows: int, cols: int, w: int) -> np.ndarray:
    """jerasure reed_sol_extended_vandermonde_matrix: row 0 = e_0, last
    row = e_{cols-1}, middle rows i = [i^0 .. i^(cols-1)]."""
    if rows > (1 << w) + 1:
        raise ValueError("extended Vandermonde needs rows <= 2^w + 1")
    V = np.zeros((rows, cols), dtype=np.uint32)
    V[0, 0] = 1
    for i in range(1, rows - 1):
        p = 1
        for j in range(cols):
            V[i, j] = p
            p = int(gf.mul(p, i, w))
    V[rows - 1, cols - 1] = 1
    return V


def jerasure_rs_vandermonde(k: int, m: int, w: int = 8) -> np.ndarray:
    """jerasure reed_sol_vandermonde_coding_matrix: reduce the top k x k
    block of the extended Vandermonde matrix to identity with row swaps
    and column operations, return the bottom m rows."""
    rows, cols = k + m, k
    D = _extended_vandermonde(rows, cols, w)
    for i in range(1, cols):
        j = i
        while j < rows and D[j, i] == 0:
            j += 1
        if j >= rows:
            raise ValueError("vandermonde reduction failed")
        if j != i:
            D[[i, j]] = D[[j, i]]
        if D[i, i] != 1:
            scale = int(gf.inv(int(D[i, i]), w))
            D[:, i] = gf.mul(D[:, i], scale, w)
        for j in range(cols):
            t = int(D[i, j])
            if j != i and t != 0:
                D[:, j] ^= gf.mul(t, D[:, i], w)
    if not np.array_equal(D[:k], np.eye(k, dtype=np.uint32)):
        raise ValueError("vandermonde reduction is not systematic")
    return D[k:].copy()


def jerasure_rs_r6(k: int, w: int = 8) -> np.ndarray:
    """reed_sol_r6_coding_matrix: m=2; row 0 all ones, row 1 powers of
    2."""
    coding = np.ones((2, k), dtype=np.uint32)
    p = 1
    for j in range(k):
        coding[1, j] = p
        p = int(gf.mul(p, 2, w))
    return coding


def decode_matrix(generator_full: np.ndarray, survivors, w: int = 8
                  ) -> np.ndarray:
    """The survivors' rows of the (k+m x k) generator, inverted: the
    k x k matrix R with data = R @ surviving_chunks (reference:
    ErasureCodeIsa.cc:226-302 builds it per erasure signature)."""
    sub = generator_full[np.asarray(list(survivors), dtype=np.int64)]
    return gf.mat_inv(sub, w)


def full_generator(coding: np.ndarray, w: int = 8) -> np.ndarray:
    """Stack the identity over the (m x k) coding block -> (k+m x k)."""
    k = coding.shape[1]
    return np.concatenate([np.eye(k, dtype=np.uint32),
                           coding.astype(np.uint32)])
