"""RSMatrixCodec — systematic Reed-Solomon over GF(2^8).

Port of ``ceph_tpu/ec/codec.py:39-140``.  Encode applies the (m x k)
coding block through ``ops.gf256``; decode inverts the survivors' k x k
generator rows on the host (cached per survivor signature, the isa
table-cache role, reference src/erasure-code/isa/
ErasureCodeIsaTableCache.cc) and applies the recovery matrix through
the same product; missing coding chunks are re-encoded from the
recovered data (jerasure_matrix_decode semantics).

The codec holds the torch device its products run on: the host byte
API moves the planes there and back.  ``BitmatrixCodec`` (the GF(2)
bit-matrix techniques) waits for the GF(2) kernel of a later slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import gf, matrices
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ops import gf256


class RSMatrixCodec(ErasureCode):
    """Systematic Reed-Solomon over GF(2^8) given an (m x k) coding
    block, its products on ``device``."""

    def __init__(self, k: int, m: int, coding: np.ndarray | None = None,
                 device=None) -> None:
        super().__init__()
        self._k = int(k)
        self._m = int(m)
        self.device = resolve_device(device)
        self._decode_cache: Dict[Tuple[int, ...],
                                 Tuple[np.ndarray, np.ndarray]] = {}
        if coding is not None:
            self.set_coding_matrix(coding)

    @property
    def k(self) -> int:
        return self._k

    @property
    def m(self) -> int:
        return self._m

    def set_coding_matrix(self, coding: np.ndarray) -> None:
        coding = np.asarray(coding, dtype=np.uint32)
        if coding.shape != (self._m, self._k):
            raise ErasureCodeError(
                f"coding matrix must be {self._m}x{self._k}, got "
                f"{coding.shape}")
        self.coding = coding
        self.full_generator = matrices.full_generator(coding)
        self.coding_u8 = np.ascontiguousarray(coding, dtype=np.uint8)
        self._decode_cache = {}

    # -- device products ---------------------------------------------------
    def encode_planes(self, planes: torch.Tensor, **kw) -> torch.Tensor:
        """uint8 [k, n] planes on the codec's device -> [m, n] coding."""
        return gf256.gf_matmul_bytes(self.coding_u8, planes, **kw)

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        return self.encode_planes(x.to(self.device)).cpu().numpy()

    def recovery_matrix(self, survivors: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-signature cached (k x k GF(2^8) matrix, its GF(2) bit-matrix
        expansion) mapping k surviving chunks to the k data chunks."""
        key = tuple(int(s) for s in survivors)
        got = self._decode_cache.get(key)
        if got is None:
            rec = matrices.decode_matrix(self.full_generator, key)
            got = (rec, gf.matrix_to_bitmatrix(rec).astype(np.int8))
            self._decode_cache[key] = got
        return got

    def decode_array(self, available: Mapping[int, np.ndarray],
                     want: Sequence[int], n: int) -> Dict[int, np.ndarray]:
        avail_ids = sorted(available.keys())
        if len(avail_ids) < self._k:
            raise ErasureCodeError(
                f"need {self._k} chunks, have {len(avail_ids)}")
        survivors = avail_ids[: self._k]
        want_data = [i for i in want if i < self._k]
        want_coding = [i for i in want if i >= self._k]
        out: Dict[int, np.ndarray] = {}
        if not (want_data or want_coding):
            return out
        rec, _ = self.recovery_matrix(survivors)
        stacked = torch.from_numpy(np.stack(
            [np.asarray(available[i], dtype=np.uint8) for i in survivors]))
        dev_data = gf256.gf_matmul_bytes(
            rec, stacked.to(self.device), donate=True)
        data = dev_data.cpu().numpy()
        for i in want_data:
            out[i] = available[i] if i in available else data[i]
        if want_coding:
            coding = self.encode_planes(dev_data).cpu().numpy()
            for i in want_coding:
                out[i] = (available[i] if i in available
                          else coding[i - self._k])
        return out
