"""Local storage layer (L5): transactional object stores.

Reference roles: ObjectStore/Transaction (src/os/ObjectStore.h,
src/os/Transaction.cc) and MemStore (src/os/memstore/ — the test-tier
fake backend, and the MiniCluster's store).

Port of ``ceph_tpu/store/``: ``objectstore`` and ``memstore``.  The
durable backends (``filestore``, ``blockstore``) and the KV layer under
them are ROADMAP queue 1 item 5; ``create`` names that item for them.
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
    if kind in ("filestore", "blockstore"):
        raise NotImplementedError(
            f"the {kind} backend is ROADMAP queue 1 item 5 (the other store "
            "backends); the port has memstore")
    raise ValueError(f"unknown objectstore {kind!r}")
