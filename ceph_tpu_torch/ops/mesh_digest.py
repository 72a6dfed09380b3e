"""The scrub digest of byte planes, the mesh's order-independent fold.

Port of the digest step of ``ceph_tpu/tpu/meshio.py:216``
(``scrub_digest``): ``sum(p.astype(uint32) * 2654435761)`` over the
planes, mod 2^32.  On a CUDA tensor :func:`mesh_digest` runs the
hand-written kernel ``csrc/meshio.cu``: a wrapping uint32 byte sum, which
is exact mod 2^32 in any order, times the constant once at the end.  On a
CPU tensor it runs :func:`mesh_digest_plain`, the reference's formula
step by step.  Any other device raises; so does a kernel that fails to
build or launch.

Both return a 0-d int64 tensor on the input's device holding the digest
in [0, 2^32).  ``gpu/meshio.MeshCompute.scrub_digest`` runs this once per
stripe row of its grid and adds the partial digests mod 2^32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ceph_tpu_torch.gpu.devwatch import instrumented_launch, signature
from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("mesh_digest")

MUL = 2654435761  # the reference's digest constant (meshio.py:230)
MASK = 0xFFFFFFFF


def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError("planes must be a torch.Tensor (its device decides "
                        "where the digest runs)")
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError(f"planes must be uint8 [rows, n], got "
                         f"{tuple(x.shape)} {x.dtype}")


def mesh_digest_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference's formula as PyTorch ops on x's device: every byte
    times the constant, summed.  Each product is below 2^40 and the int64
    sum may wrap past 2^63, but a wrapping sum keeps its low 32 bits
    exact, and those are the digest."""
    _check(x)
    return (x.to(torch.int64) * MUL).sum() & MASK


def mesh_digest(x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The digest of uint8 planes [rows, n] (any row pitch, unit column
    stride on the card).  ``out``, when given, is the int64 [2] scratch
    the kernel writes (word 0 the digest, word 1 its block ticket), so a
    timed loop allocates nothing; the result is ``out[0]``."""
    _check(x)
    if out is not None and (out.dtype != torch.int64
                            or tuple(out.shape) != (2,)
                            or out.device != x.device):
        raise ValueError(f"out must be int64 [2] on {x.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh_digest runs on cuda or cpu, not {x.device}")
    rows, n = x.shape
    if (x.device.type == "cuda" and n > 1 and rows
            and x.stride(1) != 1):
        raise ValueError("mesh_digest takes planes of unit column stride")
    return instrumented_launch("mesh_digest", signature((x,), {}),
                               lambda: _digest(x, out), x.device)


def _digest(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`mesh_digest` after its checks."""
    if x.device.type == "cpu":
        res = mesh_digest_plain(x)
        if out is None:
            return res
        out[0] = res
        return out[0]
    rows, n = x.shape
    if out is None:
        out = torch.empty(2, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().mesh_digest_launch(
        x.data_ptr(), x.stride(0), rows, n, out.data_ptr(), stream)
    launches.inc()
    _build.check(err, "mesh_digest")
    return out[0]
