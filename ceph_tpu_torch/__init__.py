"""ceph_tpu_torch — the erasure-coded data path and CRUSH on PyTorch and CUDA.

A port of ``ceph_tpu`` (the JAX package beside it, which stays the
reference) to an NVIDIA H100.  It carries the erasure-coded object
write and its degraded read, and CRUSH placement:

- ``ec``    the erasure-code plugin surface (``instance().factory``,
            ``codec_from_profile``): isa, jerasure (RS and bit-matrix
            techniques), shec and lrc;
- ``gpu``   the stripe-batch queue that coalesces concurrent encodes
            and decodes into one device batch, with its staging pool;
- ``ops``   the device kernels, hand-written in CUDA
            (``csrc/gf256.cu``, ``csrc/crc32c.cu``,
            ``csrc/gf2_matmul.cu``, ``csrc/crush.cu``), each beside a
            plain PyTorch version of the same function, plus the
            packed-planes products (planar and interleaved) and the
            bench's timing loops;
- ``osd``   the stripe geometry (object bytes <-> data planes), the
            core types, and placement on the host: OSDMap (object ->
            PG -> OSDs on the rule walk), its codec and incrementals;
- ``mgr``   the upmap and crush-compat balancers over full-pool sweeps;
- ``crush`` CRUSH placement: hashes, crush_ln, the map and its text
            compiler, and the rule walk with its staged sweeps, whose
            kernel is ``csrc/crush.cu`` (``ops/crush_rule.py``);
- ``tools`` the device EC engine bench (``python -m
            ceph_tpu_torch.tools.ecbench``), ``crushtool`` and
            ``osdmaptool``.

Every entry point takes ``device=``.  Left out, it means CUDA, and a
process without a CUDA device raises instead of running on the CPU.
``device="cpu"`` runs the plain PyTorch versions, which is what the
tests do.  Nothing here imports JAX or ``ceph_tpu``.
"""

from ceph_tpu_torch.device import resolve_device  # noqa: F401
