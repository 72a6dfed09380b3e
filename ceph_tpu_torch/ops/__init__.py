"""Device products of the data path: the GF(2^8) coding-matrix product
(``gf256``) and the batched row CRC-32C (``crc32c_device``), each a
hand-written CUDA kernel beside a plain PyTorch version."""
