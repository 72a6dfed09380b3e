"""The port's compressors (``ceph_tpu_torch/compress/``) and FileStore's
inline compression, case for case against ``tests/test_compress.py``.
``test_torch_store_xcheck.py`` holds each compressor's bytes to the
reference's."""

import numpy as np
import pytest

from ceph_tpu_torch.compress import CompressorError, instance
from ceph_tpu_torch.store.filestore import FileStore
from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction

ALGS = ["zlib", "bz2", "lzma", "zero_rle"]


@pytest.mark.parametrize("alg", ALGS)
def test_roundtrip(alg):
    c = instance().factory(alg)
    rng = np.random.default_rng(0)
    for payload in (
        b"",
        b"a" * 100_000,
        bytes(rng.integers(0, 256, size=65536, dtype=np.uint8)),
        b"\0" * 50_000 + b"x" * 100 + b"\0" * 50_000,
    ):
        assert c.decompress(c.compress(payload)) == payload


def test_registry_mirrors_ec_pattern():
    reg = instance()
    assert set(ALGS) <= set(reg.names())
    with pytest.raises(CompressorError):
        reg.factory("snappy-nope")
    reg2 = instance()
    assert reg is reg2  # singleton

    class Upper:
        name = "upper"

        def compress(self, d):
            return d

        def decompress(self, d):
            return d

    try:
        reg.add("upper", Upper)
        assert isinstance(reg.factory("upper"), Upper)
        with pytest.raises(CompressorError):
            reg.add("upper", Upper)
    finally:
        reg._factories.pop("upper", None)


def test_corrupt_input_raises():
    for alg in ("zlib", "bz2", "lzma", "zero_rle"):
        c = instance().factory(alg)
        with pytest.raises(CompressorError):
            c.decompress(b"\x02definitely-not-a-frame")


@pytest.fixture()
def store(tmp_path):
    s = FileStore(str(tmp_path / "fs"), compression="zlib")
    s.mkfs()
    s.mount()
    yield s
    s.umount()


def _put(store, coll, oid, data, off=0, create=True):
    t = Transaction()
    if create:
        t.touch(coll, oid)
    t.write(coll, oid, off, data)
    store.queue_transaction(t)


def test_filestore_compression_roundtrip(store):
    coll = Collection("c_head")
    t = Transaction()
    t.create_collection(coll)
    store.queue_transaction(t)
    g = GHObject("obj")
    data = b"compressible " * 10_000
    _put(store, coll, g, data)
    assert store.read(coll, g) == data
    assert store.stat(coll, g) == len(data)
    # actually smaller on disk
    import os

    path = store._datafile(coll, g)
    assert os.path.getsize(path) < len(data) // 2

    # ranged read
    assert store.read(coll, g, off=13, length=12) == b"compressible"

    # extent update decompresses then stores raw, content correct
    _put(store, coll, g, b"PATCH", off=100, create=False)
    got = store.read(coll, g)
    assert got[100:105] == b"PATCH" and len(got) == len(data)

    # incompressible data stays raw (no size blow-up beyond input)
    rng = np.random.default_rng(1)
    noise = bytes(rng.integers(0, 256, size=32768, dtype=np.uint8))
    g2 = GHObject("noise")
    _put(store, coll, g2, noise)
    assert store.read(coll, g2) == noise
    assert os.path.getsize(store._datafile(coll, g2)) == len(noise)


def test_filestore_truncate_and_magic_escape(store):
    coll = Collection("c2_head")
    t = Transaction()
    t.create_collection(coll)
    store.queue_transaction(t)
    g = GHObject("t")
    data = b"z" * 20_000
    _put(store, coll, g, data)
    t = Transaction()
    t.truncate(coll, g, 5000)
    store.queue_transaction(t)
    assert store.stat(coll, g) == 5000
    assert store.read(coll, g) == b"z" * 5000

    # raw content that starts with the header magic round-trips
    tricky = b"CPRS" + b"not-actually-compressed" * 10
    g3 = GHObject("tricky")
    _put(store, coll, g3, tricky)
    assert store.read(coll, g3) == tricky
    assert store.stat(coll, g3) == len(tricky)


def test_filestore_compression_survives_remount(tmp_path):
    path = str(tmp_path / "fs2")
    s = FileStore(path, compression="zlib")
    s.mkfs()
    s.mount()
    coll = Collection("c3_head")
    t = Transaction()
    t.create_collection(coll)
    s.queue_transaction(t)
    g = GHObject("persist")
    data = b"durable " * 5000
    _put(s, coll, g, data)
    s.umount()
    # remount WITHOUT compression configured: old frames still readable
    s2 = FileStore(path)
    s2.mount()
    assert s2.read(coll, g) == data
    assert s2.stat(coll, g) == len(data)
    s2.umount()
