"""Compressor plugin family.

Reference role: src/compressor/ (Compressor.h's create/registry,
plugins zlib/snappy/lz4/zstd/brotli) mirrored with the same registry
discipline as the EC plugins: name -> factory, preload at daemon start,
runtime-registrable third-party codecs.  Algorithms here are the
python-native ones (zlib/bz2/lzma from the stdlib) plus a zero-RLE
codec shaped like the storage fast paths (newly written objects are
often sparse).

The required_ratio discipline matches the reference: a compressed block
is only kept when it saves at least 1/8 of the input
(Compressor.h compressor_required_ratio default 0.875).

Port of ``ceph_tpu/compress/``: each compressor's bytes are the
reference's at the same level, since the stores write them to disk.
"""

from ceph_tpu_torch.compress.plugins import (
    Compressor,
    CompressorError,
    CompressorRegistry,
    instance,
)

__all__ = ["Compressor", "CompressorError", "CompressorRegistry",
           "instance"]
