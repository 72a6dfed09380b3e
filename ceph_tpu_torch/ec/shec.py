"""SHEC — shingled erasure code (recovery efficiency against durability).

Port of ``ceph_tpu/ec/shec.py`` (reference: src/erasure-code/shec/
ErasureCodeShec.cc):

- the generator is jerasure's Vandermonde coding matrix with a rotating
  window of zeros per parity row (shec_reedsolomon_coding_matrix); the
  (c1, m1) split of multiple-shec minimises the same recovery-efficiency
  functional (shec_calc_recovery_efficiency1);
- the code is not MDS, so a decode solves the available parity
  equations over the erased data columns: a plan picks the fewest parity
  rows that solve them (cached per erasure signature), and the solve
  runs on the device as two GF(2) bit-matrix products (``ops.gf2_matmul``)
  — the known data's contribution to those parities, then the inverse
  system on the residual;
- ``minimum_to_decode`` reads only the chosen parities and the data
  their windows touch.

Encode is the RS product of ``RSMatrixCodec``.  Defaults (k, m, c, w) =
(4, 3, 2, 8) match the reference (ErasureCodeShec.h:51-57).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import gf, matrices
from ceph_tpu_torch.ec.codec import RSMatrixCodec
from ceph_tpu_torch.ec.interface import ErasureCodeError, to_int
from ceph_tpu_torch.ops import gf2_matmul

DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8


def _recovery_efficiency1(k: int, m1: int, m2: int, c1: int,
                          c2: int) -> float:
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10**8] * k
    r_e1 = 0.0
    for m_part, c_part in ((m1, c1), (m2, c2)):
        for rr in range(m_part):
            start = (rr * k) // m_part % k
            end = ((rr + c_part) * k) // m_part % k
            span = ((rr + c_part) * k) // m_part - (rr * k) // m_part
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], span)
                cc = (cc + 1) % k
            r_e1 += span
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, w: int = 8) -> np.ndarray:
    """Vandermonde coding matrix with the shingle windows zeroed."""
    if c > m:
        raise ErasureCodeError("shec needs c <= m")
    if m == 1 or c == 1 or k <= 1:
        c1 = m1 = 0
        c2, m2 = c, m
    else:
        best = None
        for c1 in range(0, c // 2 + 1):
            for m1 in range(0, m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                    continue
                r = _recovery_efficiency1(k, m1, m2, c1, c2)
                if r >= 0 and (best is None or r < best[0] - 1e-12):
                    best = (r, c1, m1)
        if best is None:
            raise ErasureCodeError(
                f"no valid shec split for k={k} m={m} c={c}")
        _, c1, m1 = best
        c2, m2 = c - c1, m - m1

    M = matrices.jerasure_rs_vandermonde(k, m, w).copy()
    for m_part, c_part, base in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(m_part):
            end = (rr * k) // m_part % k
            cc = ((rr + c_part) * k) // m_part % k
            while cc != end:
                M[base + rr, cc] = 0
                cc = (cc + 1) % k
    return M


class ErasureCodeShec(RSMatrixCodec):
    # shec's coding matrix is not MDS: some k-subsets are singular, and a
    # read solves parity equations instead (decode_array)
    mds_recovery = False

    @classmethod
    def create(cls, profile: dict, device=None) -> "ErasureCodeShec":
        k = to_int(profile, "k", DEFAULT_K)
        m = to_int(profile, "m", DEFAULT_M)
        c = to_int(profile, "c", DEFAULT_C)
        w = to_int(profile, "w", DEFAULT_W)
        if w != 8:
            raise ErasureCodeError("shec currently supports w=8")
        if not (0 < c <= m):
            raise ErasureCodeError("shec needs 0 < c <= m")
        self = cls(k, m, shec_coding_matrix(k, m, c, w), device=device)
        self.c = c
        self._plan_cache: Dict[tuple, tuple] = {}
        self._solve_cache: Dict[tuple, tuple] = {}
        self.init(profile)
        return self

    # -- non-MDS decode: solve parity equations over erased columns -------
    def _recovery_plan(self, erased_data: Tuple[int, ...],
                       avail: Tuple[int, ...]
                       ) -> Tuple[List[int], List[int]]:
        """The cheapest set of parity rows that solves the erased data
        columns: (parity_ids, data ids those rows read).  Cached per
        (erased, available) signature."""
        cache_key = (erased_data, avail)
        cached = self._plan_cache.get(cache_key)
        if cached is not None:
            return cached
        avail_set = set(avail)
        parities = [i for i in avail if i >= self.k]
        best = None
        for r in range(len(erased_data), len(parities) + 1):
            for combo in itertools.combinations(parities, r):
                rows = np.stack([self.coding[p - self.k] for p in combo])
                try:
                    gf.solve(rows[:, list(erased_data)],
                             np.zeros((len(combo), 1)), 8)
                except ValueError:
                    continue
                used = {j for p in combo for j in range(self.k)
                        if self.coding[p - self.k][j]
                        and j not in erased_data}
                if not used <= avail_set:
                    continue
                cost = len(combo) + len(used)
                if best is None or cost < best[0]:
                    best = (cost, list(combo), sorted(used))
            if best is not None:
                break
        if best is None:
            raise ErasureCodeError("shec: erasures not recoverable")
        plan = (best[1], best[2])
        self._plan_cache[cache_key] = plan
        return plan

    def _minimum_to_decode(self, want_to_read: Iterable[int],
                           available: Iterable[int]) -> List[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return sorted(want)
        erased_want_data = tuple(sorted(i for i in want - avail
                                        if i < self.k))
        erased_want_coding = [i for i in want - avail if i >= self.k]
        minimum = set(want & avail)
        if erased_want_data or erased_want_coding:
            # coding chunks are re-encoded from the full data, so they
            # need every erased data column
            need = set(erased_want_data)
            if erased_want_coding:
                need |= set(range(self.k)) - avail
            if need:
                parity_ids, data_used = self._recovery_plan(
                    tuple(sorted(need)), tuple(sorted(avail)))
                minimum |= set(parity_ids) | set(data_used)
                if erased_want_coding:
                    minimum |= {i for i in range(self.k) if i in avail}
        return sorted(minimum)

    def solve_operands(self, erased_data: Tuple[int, ...],
                       avail: Tuple[int, ...]):
        """(parity_ids, s_bits, contrib_bits) for one erasure signature,
        the two bit-matrices as kernel operands: contrib maps the data
        [k, n] (erased rows zero) to the chosen parities' known part,
        s solves the residual [r, n] for the erased rows."""
        parity_ids, _ = self._recovery_plan(erased_data, avail)
        skey = (erased_data, tuple(parity_ids))
        cached = self._solve_cache.get(skey)
        if cached is None:
            rows = np.stack([self.coding[p - self.k] for p in parity_ids])
            A = rows[:, list(erased_data)]
            s_bits = gf2_matmul.prepare_bitmatrix(
                gf.solve(A, np.eye(len(parity_ids), dtype=np.uint32), 8))
            known = rows.copy()
            known[:, list(erased_data)] = 0
            cached = (gf2_matmul.BitOperand(s_bits),
                      gf2_matmul.BitOperand(
                          gf2_matmul.prepare_bitmatrix(known)))
            self._solve_cache[skey] = cached
        return (parity_ids,) + cached

    def decode_array(self, available: Mapping[int, np.ndarray],
                     want: Sequence[int], n: int) -> Dict[int, np.ndarray]:
        avail_ids = sorted(available.keys())
        avail_set = set(avail_ids)
        want_missing = [i for i in want if i not in avail_set]
        out = {i: np.asarray(available[i]) for i in want if i in avail_set}
        if not want_missing:
            return out
        # every wanted chunk is missing data, or coding re-encoded from
        # the full data: either way all erased data columns are solved
        erased_data = tuple(i for i in range(self.k) if i not in avail_set)
        need_coding = [i for i in want_missing if i >= self.k]
        host = np.zeros((self.k, n), dtype=np.uint8)
        for i in range(self.k):
            if i in avail_set:
                host[i] = np.asarray(available[i], dtype=np.uint8)
        data = torch.from_numpy(host).to(self.device)
        if erased_data:
            parity_ids, s_op, contrib_op = self.solve_operands(
                erased_data, tuple(avail_ids))
            parity = torch.from_numpy(np.stack(
                [np.asarray(available[p], dtype=np.uint8)
                 for p in parity_ids])).to(self.device)
            residual = gf2_matmul.gf2_matmul_bytes(contrib_op, data)
            residual ^= parity
            solved = gf2_matmul.gf2_matmul_bytes(s_op, residual)
            data[list(erased_data)] = solved
            host = data.cpu().numpy()
        for i in want_missing:
            if i < self.k:
                out[i] = host[i]
        if need_coding:
            coding = self.encode_planes(data).cpu().numpy()
            for i in need_coding:
                out[i] = coding[i - self.k]
        return out
