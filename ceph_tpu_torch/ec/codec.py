"""Device codecs: Reed-Solomon over GF(2^8) and GF(2) bit-matrix codes.

Port of ``ceph_tpu/ec/codec.py``.

- ``RSMatrixCodec`` (``codec.py:39-140``): encode applies the (m x k)
  coding block through ``ops.gf256``; decode inverts the survivors' k x k
  generator rows on the host (cached per survivor signature, the isa
  table-cache role, reference src/erasure-code/isa/
  ErasureCodeIsaTableCache.cc) and applies the recovery matrix through
  the same product; missing coding chunks are re-encoded from the
  recovered data (jerasure_matrix_decode semantics).
- ``BitmatrixCodec`` (``codec.py:143-265``): the jerasure bit-matrix
  techniques.  Each chunk row is w packets and the (m*w x k*w) 0/1
  matrix XORs packets together, through ``ops.gf2_matmul``; decode
  inverts the survivors' k*w GF(2) rows on the host, per signature.

A codec holds the torch device its products run on: the host byte API
moves the planes there and back.  ``encode_planes`` is the device entry
of the stripe-batch queue.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import gf, matrices
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ops import gf2_matmul, gf256

Jobs = Optional[Tuple[Sequence[int], Sequence[int]]]


class RSMatrixCodec(ErasureCode):
    """Systematic Reed-Solomon over GF(2^8) given an (m x k) coding
    block, its products on ``device``."""

    # any k of the k+m chunks rebuild the data through one k x k matrix
    # (recovery_matrix); the queue's ``dec`` batches only such codecs
    mds_recovery = True

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
    def encode_planes(self, planes: torch.Tensor,
                      out: Optional[torch.Tensor] = None,
                      jobs: Jobs = None) -> torch.Tensor:
        """uint8 [k, n] planes on the codec's device -> [m, n] coding,
        into ``out`` when given.  ``jobs`` (offsets, widths of jobs laid
        side by side) needs no handling here: RS coding is column-local,
        so one product codes every job and the pad between them."""
        return gf256.gf_matmul_bytes(self.coding_u8, planes, out=out)

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


def _gf2_mat_inv(A: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2) (host, Gauss-Jordan)."""
    A = np.array(A, dtype=np.uint8) & 1
    n = A.shape[0]
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = col + int(np.argmax(aug[col:, col]))
        if aug[pivot, col] == 0:
            raise ErasureCodeError("singular GF(2) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        rows = np.nonzero(aug[:, col])[0]
        rows = rows[rows != col]
        aug[rows] ^= aug[col]
    return aug[:, n:].copy()


class BitmatrixCodec(ErasureCode):
    """GF(2) bit-matrix code applied at packet granularity, its products
    on ``device``.

    The techniques jerasure calls "schedule" codes (cauchy_orig,
    cauchy_good, liberation, blaum_roth, liber8tion; reference:
    src/erasure-code/jerasure/ErasureCodeJerasure.h:118-247): a job's
    chunk row of n bytes is w packets of n/w bytes, and the (m*w x k*w)
    0/1 matrix XORs packets together.  A 0/1 matrix acting on byte
    packets is a GF(2^8) matrix with 0/1 coefficients, so the product is
    the one GF(2) engine with each entry expanded to a zero or identity
    8x8 block (``prepare_bitmatrix``)."""

    def __init__(self, k: int, m: int, w: int, bitmatrix: np.ndarray,
                 device=None) -> None:
        super().__init__()
        self._k = int(k)
        self._m = int(m)
        self.w = int(w)
        self.device = resolve_device(device)
        coding = np.asarray(bitmatrix, dtype=np.uint8).reshape(
            self._m * self.w, self._k * self.w)
        self.coding_bits = coding
        self.full_bits = np.concatenate(
            [np.eye(self._k * self.w, dtype=np.uint8), coding])
        self._decode_cache: Dict[Tuple[int, ...], np.ndarray] = {}
        self._operands: Dict[bytes, gf2_matmul.BitOperand] = {}

    @property
    def k(self) -> int:
        return self._k

    @property
    def m(self) -> int:
        return self._m

    def get_alignment(self) -> int:
        # whole w-packet groups in every chunk (jerasure's alignment is
        # likewise k*w*sizeof(int), ErasureCodeJerasure.cc get_alignment)
        return self._k * self.w * 16

    def supports_partial_writes(self) -> bool:
        # a chunk row is w packets of n/w bytes: a parity byte mixes
        # bytes n/w apart, so an extent re-encoded alone takes other
        # packets than the whole chunk did (the reference answers True
        # here and its RMW then writes parity no decode agrees with)
        return False

    def operand(self, M: np.ndarray) -> gf2_matmul.BitOperand:
        """The prepared bit-matrix of the 0/1 packet matrix M, cached per
        matrix so its masks cross to the card once."""
        key = M.tobytes() + bytes(str(M.shape), "ascii")
        op = self._operands.get(key)
        if op is None:
            op = gf2_matmul.BitOperand(
                gf2_matmul.prepare_bitmatrix(M.astype(np.uint32)))
            self._operands[key] = op
        return op

    def _apply(self, M: np.ndarray, planes: torch.Tensor,
               out: Optional[torch.Tensor] = None,
               jobs: Jobs = None) -> torch.Tensor:
        """Packet XOR-matmul of chunk rows planes [c, P] -> [M rows / w,
        P]: each job's columns (all P when ``jobs`` is None) split into w
        packets per chunk row."""
        n = planes.shape[1]
        offs, widths = jobs if jobs is not None else ([0], [n])
        if any(int(wd) % self.w for wd in widths):
            raise ErasureCodeError(
                f"chunk width not a multiple of w={self.w}: "
                f"{list(widths)}")
        if out is None:
            out = torch.empty((M.shape[0] // self.w, n), dtype=torch.uint8,
                              device=planes.device)
        return gf2_matmul.gf2_matmul_packets(self.operand(M), planes, out,
                                             offs, widths, self.w)

    # -- device products ---------------------------------------------------
    def encode_planes(self, planes: torch.Tensor,
                      out: Optional[torch.Tensor] = None,
                      jobs: Jobs = None) -> torch.Tensor:
        """uint8 [k, n] planes on the codec's device -> [m, n] coding,
        into ``out`` when given.  ``jobs`` = (offsets, widths) of jobs
        laid side by side: each is coded as ``encode_array`` codes it on
        its own (its own packet width), in one launch per 240 jobs;
        columns outside the jobs are not written."""
        return self._apply(self.coding_bits, planes, out, jobs)

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        return self.encode_planes(x.to(self.device)).cpu().numpy()

    def recovery_bits(self, survivors: Sequence[int]) -> np.ndarray:
        """Per-signature cached GF(2) inverse of the survivors' k*w
        generator rows: k*w survivor packet rows -> k*w data packet
        rows."""
        key = tuple(int(s) for s in survivors)
        rec = self._decode_cache.get(key)
        if rec is None:
            w = self.w
            rec = _gf2_mat_inv(np.concatenate(
                [self.full_bits[c * w:(c + 1) * w] for c in key]))
            self._decode_cache[key] = rec
        return rec

    def decode_array(self, available: Mapping[int, np.ndarray],
                     want: Sequence[int], n: int) -> Dict[int, np.ndarray]:
        avail_ids = sorted(available.keys())
        if len(avail_ids) < self._k:
            raise ErasureCodeError("not enough chunks")
        survivors = avail_ids[: self._k]
        rec = self.recovery_bits(survivors)
        stacked = torch.from_numpy(np.stack(
            [np.asarray(available[i], dtype=np.uint8) for i in survivors]))
        dev_data = self._apply(rec, stacked.to(self.device))
        data = dev_data.cpu().numpy()
        out: Dict[int, np.ndarray] = {}
        coding = None
        for i in want:
            if i in available:
                out[i] = np.asarray(available[i])
            elif i < self._k:
                out[i] = data[i]
            else:
                if coding is None:
                    coding = self.encode_planes(dev_data).cpu().numpy()
                out[i] = coding[i - self._k]
        return out
