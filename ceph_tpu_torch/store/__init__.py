"""Local storage layer (L5): transactional object stores + KV abstraction.

Reference roles: ObjectStore/Transaction (src/os/ObjectStore.h,
src/os/Transaction.cc), MemStore (src/os/memstore/ — the test-tier fake
backend), a journaled file-backed store standing in for
FileStore/BlueStore (src/os/filestore/, src/os/bluestore/), and the
pluggable KeyValueDB (src/kv/KeyValueDB.h) the metadata path rides on.

Port of ``ceph_tpu/store/``, module for module: ``objectstore``,
``memstore``, ``kv``, ``lsm``, ``filestore`` and ``blockstore``.  What
one package writes to disk, the other mounts: the WAL and KV log
framing, the LSM tables, the block files and their onodes are the
reference's byte for byte.
"""

from ceph_tpu_torch.store.objectstore import (  # noqa: F401
    Collection,
    GHObject,
    ObjectStore,
    StoreError,
    Transaction,
)


def create(kind: str, path: str = "", **kw):
    """ObjectStore::create equivalent (reference: src/os/ObjectStore.cc)."""
    if kind == "memstore":
        from ceph_tpu_torch.store.memstore import MemStore

        return MemStore(**kw)
    if kind == "filestore":
        from ceph_tpu_torch.store.filestore import FileStore

        return FileStore(path, **kw)
    if kind == "blockstore":
        from ceph_tpu_torch.store.blockstore import BlockStore

        return BlockStore(path, **kw)
    raise ValueError(f"unknown objectstore {kind!r}")
