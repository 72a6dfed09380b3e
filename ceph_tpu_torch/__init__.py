"""ceph_tpu_torch — the erasure-coded data path on PyTorch and CUDA.

A port of ``ceph_tpu`` (the JAX package beside it, which stays the
reference) to an NVIDIA H100.  This slice carries the erasure-coded
object write and its degraded read:

- ``ec``    the erasure-code plugin surface (``instance().factory``,
            ``codec_from_profile``), RS codecs for isa and jerasure;
- ``gpu``   the stripe-batch queue that coalesces concurrent encodes
            and decodes into one device batch, with its staging pool;
- ``ops``   the two device kernels of that path, hand-written in CUDA
            (``csrc/gf256.cu``, ``csrc/crc32c.cu``), each beside a plain
            PyTorch version of the same function;
- ``osd``   the stripe geometry (object bytes <-> data planes).

Every entry point takes ``device=``.  Left out, it means CUDA, and a
process without a CUDA device raises instead of running on the CPU.
``device="cpu"`` runs the plain PyTorch versions, which is what the
tests do.  Nothing here imports JAX or ``ceph_tpu``.
"""

from ceph_tpu_torch.device import resolve_device  # noqa: F401
