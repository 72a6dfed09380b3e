"""Device products of the data path: the GF(2^8) coding-matrix product
(``gf256``; over packed planes, planar and interleaved, in
``gf256_planes``), the GF(2) bit-matrix product (``gf2_matmul``) and the
batched row CRC-32C (``crc32c_device``), each a hand-written CUDA kernel
beside a plain PyTorch version; and the engine bench's generator and
timing loops (``mix32``, ``benchloop``)."""
