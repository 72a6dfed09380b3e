"""MeshCompute — the erasure-code data plane over a grid of devices.

Port of ``ceph_tpu/tpu/meshio.py`` (K8), the reference's SPMD programs
over a device mesh with axes ``("stripe", "shard")``: data parallelism
over a batch's stripe columns times parallelism over the coding rows,
the k+m chunk fan-out of ECBackend mapped onto devices.  The contract is
the reference's single controller: one process holds the device list,
the stripe-batch queue's worker calls a program and gets the whole
result back.  The three programs keep their names and results:

- :meth:`MeshCompute.encode_scatter`: each cell encodes its stripe
  row's column slice and writes its share of the coding rows (the write
  fan-out);
- :meth:`MeshCompute.recovery_gather`: the same over a decode matrix:
  each cell rebuilds its share of the lost rows from the survivor
  planes of its column slice (the degraded-read fan-in);
- :meth:`MeshCompute.scrub_digest`: each stripe row's first cell folds
  its column slice into a digest (the kernel ``csrc/meshio.cu`` through
  ``ops/mesh_digest.py``) and the partials add mod 2^32 (the ``psum``
  over ``"stripe"``), so no chunk byte moves.

The grid.  ``MeshCompute(devices, shard_par)`` lays the devices out as
``dp`` stripe rows of ``shard_par`` cells, the reference's factorization
(``shard_par`` 2 for an even count above 1, else 1).  ``devices=None``
means every CUDA card of the host and raises without one.  A list may
name a device more than once; each entry is one cell, which is how a
single card (or the CPU, in the tests) holds the reference's 4 x 2 mesh.
A list that mixes CPU and CUDA devices is refused.

What differs from the XLA programs, with the same bytes:

- a cell computes only its rows.  The reference computes all m rows on
  every shard cell, keeps its slice and ``all_gather``s the slices over
  ``"shard"``; here cell (i, s) runs K1 (``ops/gf256.gf_matmul_bytes``)
  for rows ``s*R/shard_par .. (s+1)*R/shard_par`` of the matrix, and the
  gather is each cell's rows landing in the result: written in place
  through K1's ``out=`` when the cell lies on the result's device, else
  copied there (peer to peer between cards).  When R is not a multiple
  of ``shard_par`` every cell computes all R rows, as the reference does
  (``meshio.py:137-138``), and the stripe row's first cell writes them;
- nothing is compiled, so nothing is cached per program; K1 caches its
  operand per matrix (``gf256.k1_operand``);
- the columns pad to the reference's bucket (``shapebucket.covering``
  with unit ``4 * dp``; ``dp`` for the digest), so a cell's slice is a
  whole number of words; the pad is zeros and is cut off the result;
- each card runs its cells on its current CUDA stream, so cells on
  different cards run at once; cells that share a card run in order.
  PyTorch orders the copies between cards against both cards' streams.

A result comes back as host numpy, or with ``keep_device=True`` as a
torch tensor on the input's device (on cell (0, 0)'s device for a numpy
input), with no host hop in between.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.gpu import shapebucket
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.ops.mesh_digest import MASK, mesh_digest


def _on(dev: torch.device):
    """The CUDA device context a cell's launches need (a kernel goes to a
    stream of the current device only); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _as_planes(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"planes must be uint8 [rows, n], got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t


class MeshCompute:
    def __init__(self, devices: Optional[Sequence] = None,
                 shard_par: Optional[int] = None) -> None:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device available; pass devices=['cpu'] * n "
                    "for a mesh of plain versions on the CPU")
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [torch.device(d) for d in devices]
            if not devs:
                raise ValueError("a mesh needs at least one device")
            kinds = sorted({d.type for d in devs})
            if len(kinds) > 1:
                raise ValueError(f"a mesh lies on one kind of device, got "
                                 f"{kinds}")
            devs = [resolve_device(d) for d in devs]
        if shard_par is None:
            shard_par = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
        if not 1 <= shard_par <= len(devs):
            raise ValueError(f"shard_par {shard_par} needs 1 to "
                             f"{len(devs)} devices a stripe row")
        self.shard_par = int(shard_par)
        self.dp = len(devs) // self.shard_par
        self.devices: List[torch.device] = devs[:self.dp * self.shard_par]
        # grid[i][s]: the cell of stripe row i, shard s
        self.grid = [self.devices[i * self.shard_par:
                                  (i + 1) * self.shard_par]
                     for i in range(self.dp)]

    # -- programs ----------------------------------------------------------
    def encode_scatter(self, coding: np.ndarray, x,
                       keep_device: bool = False):
        """RS encode: data planes x [k, n] (numpy or a tensor) -> coding
        [m, n], each cell writing its rows of its column slice."""
        return self._product(coding, x, keep_device)

    def recovery_gather(self, rec: np.ndarray, survivors,
                        keep_device: bool = False):
        """Decode: survivor planes [s, n] through rec [r, s] -> the
        rebuilt rows [r, n], column-sharded as encode_scatter."""
        return self._product(rec, survivors, keep_device)

    def scrub_digest(self, planes) -> int:
        """The u32 digest ``sum(byte * 2654435761) mod 2^32`` of planes
        [rows, n] (numpy or a tensor): one ``mesh_digest`` launch a
        stripe row over its column slice, the partials added mod 2^32.
        The zero pad adds nothing, so a slice is read only as far as the
        real columns go."""
        src = _as_planes(planes)
        n = src.shape[1]
        w = shapebucket.covering(n, self.dp) // self.dp
        parts = []
        for i, row in enumerate(self.grid):
            with _on(row[0]):
                xs = src[:, i * w:(i + 1) * w]
                if xs.device != row[0]:
                    xs = xs.to(row[0], non_blocking=True)
                parts.append(mesh_digest(xs))
        return sum(int(p.item()) for p in parts) & MASK

    # -- the column- and row-sharded product -------------------------------
    def _product(self, matrix, x, keep_device: bool):
        mat = np.ascontiguousarray(np.asarray(matrix), dtype=np.uint8)
        R, k = mat.shape
        src = _as_planes(x)
        if src.shape[0] != k:
            raise ValueError(f"a {R}x{k} matrix takes [{k}, n] planes, got "
                             f"{tuple(src.shape)}")
        home = (x.device if isinstance(x, torch.Tensor)
                else self.grid[0][0])
        n = src.shape[1]
        P = shapebucket.covering(n, 4 * self.dp)
        w = P // self.dp
        if P == n and src.device == home:
            xp = src
        else:
            xp = torch.empty((k, P), dtype=torch.uint8, device=home)
            xp[:, :n].copy_(src)
            xp[:, n:].zero_()
        out = torch.empty((R, P), dtype=torch.uint8, device=home)
        split = R % self.shard_par == 0
        rows = R // self.shard_par if split else R
        for i, row in enumerate(self.grid):
            cols = slice(i * w, (i + 1) * w)
            slices = {}  # one copy of the column slice a device
            for s, dev in enumerate(row):
                r0 = s * rows if split else 0
                sub = mat[r0:r0 + rows]
                keep = split or s == 0
                with _on(dev):
                    xs = slices.get(dev)
                    if xs is None:
                        xs = xp[:, cols]
                        if dev != home:
                            xs = xs.to(dev, non_blocking=True)
                        slices[dev] = xs
                    if keep and dev == home:
                        gf256.gf_matmul_bytes(
                            sub, xs, out=out[r0:r0 + rows, cols])
                        continue
                    res = gf256.gf_matmul_bytes(sub, xs)
                    if keep:
                        out[r0:r0 + rows, cols].copy_(res,
                                                      non_blocking=True)
                    # else: a replica of the stripe row's rows, which
                    # the reference keeps on every shard cell and the
                    # result takes once
        res = out[:, :n] if P != n else out
        return res if keep_device else res.cpu().numpy()
