"""The port's durable stores and compressors held against ``ceph_tpu``'s,
byte for byte on disk and both ways across a mount.

- Each compressor gives the reference's bytes on the same input, and
  each package decompresses the other's.
- One seeded list of transactions (encoded once, decoded by each
  package's own ``Transaction``) goes into a FileStore (plain and with
  zlib) and a BlockStore (``kv_kind`` ``log`` and ``lsm``, and with
  zero-RLE) of each package: after ``umount`` every file of the two
  directories is equal byte for byte.
- A directory one package wrote mounts in the other and reads back
  equal (objects, xattrs, omap, collections), in both directions; so
  does a FileStore left by a crash, whose WAL the other package replays.
- ``LSMStore`` and ``LogKV``: the same seeded batches give the same
  files in both packages, and each opens the other's.
"""

import importlib
import os

import numpy as np
import pytest

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
SEED = 24
STORES = [
    ("filestore", {}),
    ("filestore", {"compression": "zlib"}),
    ("blockstore", {"kv_kind": "log"}),
    ("blockstore", {"kv_kind": "lsm"}),
    ("blockstore", {"kv_kind": "log", "compression": "zero_rle"}),
]
STORE_IDS = ["filestore", "filestore-zlib", "blockstore-log",
             "blockstore-lsm", "blockstore-zero_rle"]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _payload(rng) -> bytes:
    """Random bytes, zero runs or a repeated phrase: every compressor
    keeps some blobs and refuses others."""
    n = int(rng.integers(1, 20000))
    kind = int(rng.integers(0, 3))
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        buf = np.zeros(n, np.uint8)
        buf[rng.integers(0, n, max(1, n // 50))] = 7
        return buf.tobytes()
    return (b"ceph shard " * (n // 11 + 1))[:n]


def _txn_bytes(seed: int = SEED) -> list:
    """The seeded transactions, as the reference encodes them."""
    os_ = _mod(REF, "store.objectstore")
    rng = np.random.default_rng(seed)
    colls = [os_.Collection(f"1.{i}_head") for i in range(3)]
    out = []
    t = os_.Transaction()
    for c in colls:
        t.create_collection(c)
    out.append(t.to_bytes())
    live = set()
    for step in range(60):
        t = os_.Transaction()
        c = colls[int(rng.integers(0, len(colls)))]
        g = os_.GHObject(f"obj{int(rng.integers(0, 8))}",
                         shard=int(rng.integers(-1, 3)))
        op = int(rng.integers(0, 9))
        key = (c.name, g)
        if op <= 2 or key not in live:
            t.write(c, g, int(rng.integers(0, 3)) * 4096, _payload(rng))
            live.add(key)
        elif op == 3:
            t.zero(c, g, int(rng.integers(0, 8192)),
                   int(rng.integers(1, 8192)))
        elif op == 4:
            t.truncate(c, g, int(rng.integers(0, 12000)))
        elif op == 5:
            t.setattrs(c, g, {f"a{int(rng.integers(0, 4))}":
                              rng.bytes(int(rng.integers(1, 64)))})
            t.omap_setkeys(c, g, {f"k{step}": rng.bytes(16)})
        elif op == 6:
            dst = os_.GHObject(g.name + "_clone", shard=g.shard)
            t.clone(c, g, dst)
            live.add((c.name, dst))
        elif op == 7:
            t.omap_rmkeys(c, g, [f"k{step - 1}"])
            t.rmattr(c, g, "a0")
        else:
            t.remove(c, g)
            live.discard(key)
        out.append(t.to_bytes())
    return out


def _store(pkg: str, kind: str, path: str, kw: dict):
    return _mod(pkg, "store").create(kind, path=path, **kw)


def _fill(pkg: str, kind: str, path: str, kw: dict, crash: bool = False):
    Transaction = _mod(pkg, "store.objectstore").Transaction
    st = _store(pkg, kind, path, kw)
    st.mkfs()
    st.mount()
    for blob in _txn_bytes():
        st.queue_transaction(Transaction.from_bytes(blob))
    if crash:
        return st
    snap = _dump(st)
    st.umount()
    return snap


def _dump(st) -> dict:
    out = {}
    for c in sorted(st.list_collections(), key=lambda c: c.name):
        out[c.name] = [
            ((g.name, g.shard, g.snap), bytes(st.read(c, g)),
             dict(st.getattrs(c, g)), dict(st.omap_get(c, g)))
            for g in sorted(st.collection_list(c),
                            key=lambda g: (g.name, g.shard, g.snap))]
    return out


def _files(root: str) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# -- compressors -----------------------------------------------------------


@pytest.mark.parametrize("name", ["none", "zlib", "bz2", "lzma", "zero_rle"])
def test_compressors_give_the_reference_bytes(name):
    ref = _mod(REF, "compress").instance().factory(name)
    port = _mod(PORT, "compress").instance().factory(name)
    rng = np.random.default_rng(SEED)
    for _ in range(6):
        data = _payload(rng)
        got = port.compress(data)
        assert got == ref.compress(data)
        assert ref.decompress(got) == data
        assert port.decompress(got) == data
    assert port.compress(b"") == ref.compress(b"")


@pytest.mark.parametrize("level", [1, 5, 9])
def test_zlib_levels_give_the_reference_bytes(level):
    ref = _mod(REF, "compress.plugins").ZlibCompressor(level)
    port = _mod(PORT, "compress.plugins").ZlibCompressor(level)
    data = _payload(np.random.default_rng(level))
    assert port.compress(data) == ref.compress(data)


def test_registries_name_the_same_compressors():
    assert (_mod(PORT, "compress").instance().names()
            == _mod(REF, "compress").instance().names())


# -- object stores ---------------------------------------------------------


@pytest.mark.parametrize("kind,kw", STORES, ids=STORE_IDS)
def test_both_packages_write_the_same_files(kind, kw, tmp_path):
    snaps = {pkg: _fill(pkg, kind, str(tmp_path / pkg), kw)
             for pkg in (REF, PORT)}
    assert snaps[PORT] == snaps[REF]
    assert any(objs for objs in snaps[REF].values())
    ref_files = _files(str(tmp_path / REF))
    assert ref_files and _files(str(tmp_path / PORT)) == ref_files


@pytest.mark.parametrize("kind,kw", STORES, ids=STORE_IDS)
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_a_store_mounts_in_the_other_package(kind, kw, writer, reader,
                                             tmp_path):
    path = str(tmp_path / "store")
    snap = _fill(writer, kind, path, kw)
    st = _store(reader, kind, path, kw)
    st.mount()
    try:
        assert _dump(st) == snap
        if kind == "blockstore":
            assert st.fsck() == []
        # the reader writes on and mounts again
        Transaction = _mod(reader, "store.objectstore").Transaction
        Collection = _mod(reader, "store.objectstore").Collection
        GHObject = _mod(reader, "store.objectstore").GHObject
        t = Transaction()
        t.write(Collection("1.0_head"), GHObject("after"), 0, b"z" * 5000)
        st.queue_transaction(t)
    finally:
        st.umount()
    back = _store(writer, kind, path, kw)
    back.mount()
    try:
        got = _dump(back)
        assert got["1.0_head"] == sorted(
            snap["1.0_head"] + [(("after", -1, -2), b"z" * 5000, {}, {})])
    finally:
        back.umount()


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_filestore_wal_replays_in_the_other_package(writer, reader,
                                                    tmp_path):
    """A FileStore killed without umount, its KV rolled back to
    applied_seq 0 (the metadata batch never landed): the other package
    replays the writer's WAL on mount."""
    path = str(tmp_path / "fs")
    want = _fill(writer, "filestore", str(tmp_path / "clean"), {})
    st = _fill(writer, "filestore", path, {}, crash=True)
    b = _mod(writer, "store.kv").WriteBatch()
    b.set("S", "applied_seq", b"0")
    st._kv.submit(b, sync=True)
    st._kv.close()
    st._wal_fh.close()
    st._pipeline.stop()
    other = _store(reader, "filestore", path, {})
    other.mount()
    try:
        assert _dump(other) == want
    finally:
        other.umount()


# -- key-value stores ------------------------------------------------------


def _batches(pkg: str, n: int = 40) -> list:
    WriteBatch = _mod(pkg, "store.kv").WriteBatch
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n):
        b = WriteBatch()
        for _ in range(int(rng.integers(1, 12))):
            key = f"k{int(rng.integers(0, 200)):04d}"
            if rng.integers(0, 5) == 0:
                b.rmkey("P", key)
            else:
                b.set("P", key, rng.bytes(int(rng.integers(1, 3000))))
        b.set("M", f"m{i}", str(i).encode())
        out.append(b)
    return out


def _kv(pkg: str, kind: str, path: str):
    if kind == "lsm":
        return _mod(pkg, "store.lsm").LSMStore(path, memtable_bytes=16384,
                                               compact_tables=3)
    return _mod(pkg, "store.kv").LogKV(path)


def _kv_dump(kv) -> dict:
    return {p: list(kv.iterate(p)) for p in ("P", "M")}


@pytest.mark.parametrize("kind", ["logkv", "lsm"])
def test_kv_files_equal_and_open_across_packages(kind, tmp_path):
    dumps = {}
    for pkg in (REF, PORT):
        kv = _kv(pkg, kind, str(tmp_path / pkg / "kv"))
        os.makedirs(str(tmp_path / pkg), exist_ok=True)
        kv.open()
        for b in _batches(pkg):
            kv.submit(b)
        dumps[pkg] = _kv_dump(kv)
        kv.close()
    assert dumps[PORT] == dumps[REF] and dumps[REF]["P"]
    assert _files(str(tmp_path / PORT)) == _files(str(tmp_path / REF))
    for writer, reader in ((REF, PORT), (PORT, REF)):
        kv = _kv(reader, kind, str(tmp_path / writer / "kv"))
        kv.open()
        try:
            assert _kv_dump(kv) == dumps[writer]
        finally:
            kv.close()
