"""The u32 splitmix-style mixer of the engine bench, numpy and torch twins.

Port of ``ceph_tpu/ops/mix32.py``.  The bench makes its data on the
device (``benchloop.gen_planes``) and pins each engine against an oracle
over a host mirror of the same bytes, which works only if the device
generator and the host mirror compute bit-identical streams: both twins
live here.

``mix_np`` is a copy of the reference's.  ``mix_torch`` is its twin on
tensors.  PyTorch's uint32 support is thin (several ops are missing on
CUDA), so it computes in int64, multiplies in 16-bit halves masked to
32 bits (a full 32 x 32-bit product would leave int64's range), and
returns int32 tensors holding the u32 bit patterns: a value >= 2^31
has 2^32 subtracted explicitly rather than trusting an overflowing cast.
"""

from __future__ import annotations

import numpy as np
import torch

_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_MASK = 0xFFFFFFFF


def mix_np(i: np.ndarray) -> np.ndarray:
    """u32 ndarray -> mixed u32 ndarray (wrapping arithmetic)."""
    i = i.astype(np.uint32, copy=False)
    z = (i ^ np.uint32(_C1)) * np.uint32(_C2)
    z = (z ^ (z >> np.uint32(13))) * np.uint32(_C3)
    return z ^ (z >> np.uint32(16))


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for int64 z, c in [0, 2^32), in two 16-bit halves
    so that no product leaves int64's range."""
    lo = (z & 0xFFFF) * c
    hi = ((z >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def mix_torch(i: torch.Tensor) -> torch.Tensor:
    """Integer tensor (its values taken mod 2^32) -> int32 tensor of the
    mixed u32 words, on ``i``'s device; mirrors :func:`mix_np` exactly."""
    z = i.to(torch.int64) & _MASK
    z = _mul32(z ^ _C1, _C2)
    z = _mul32(z ^ (z >> 13), _C3)
    z = z ^ (z >> 16)
    return torch.where(z >= 1 << 31, z - (1 << 32), z).to(torch.int32)
