"""Scrub repair against at-rest corruption under the port's BlockStore,
case for case against ``tests/test_scrub_repair_blockstore.py``: bytes
flipped in the raw block file behind a live port OSD, BlockStore's
CRC-32C at rest refusing them, scrub marking the object inconsistent,
repair rebuilding the shard from its peers, and a clean read after.

The cluster is the port's, ``torch_daemon_harness.DaemonCluster(
"ceph_tpu_torch", store_factory=...)`` (six port daemons, each on a
BlockStore of its own, the reference's map, ``device="cpu"``), driven
through the port's client (``torch_daemon_harness.LibClient``).
"""

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.store.blockstore import BlockStore
from ceph_tpu_torch.store.objectstore import Collection, GHObject

EC_POOL, N_OSDS = H.EC_POOL, H.N_OSDS


@pytest.fixture(scope="module")
def bcluster(tmp_path_factory):
    base = tmp_path_factory.mktemp("bstores")
    c = H.DaemonCluster(
        "ceph_tpu_torch",
        store_factory=lambda i: BlockStore(str(base / f"osd{i}")))
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def bclient(bcluster):
    cl = H.LibClient(bcluster)
    yield cl
    cl.shutdown()


def _flip_at_rest(store: BlockStore, pattern: bytes) -> None:
    """Byte-flip the on-device copy of `pattern` behind the store."""
    store._dev_fh.flush()
    with open(store._dev_path, "r+b") as f:
        raw = f.read()
        pos = raw.find(pattern)
        assert pos >= 0, "shard bytes not found on device"
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in pattern[:16]))
    # drop caches so reads hit the flipped media
    store._onodes.clear()
    store._blobs.clear()


def test_repair_after_at_rest_byte_flip(bcluster, bclient):
    payload = b"media-rot-survivor" * 800
    bclient.put(EC_POOL, "atrest", payload)
    pgid, acting, primary = bcluster.primary_of(EC_POOL, "atrest")
    pg = bcluster.osds[primary].pgs[pgid]
    assert pg.scrub().get("atrest") is None

    coll = Collection(t_.pgid_str(pgid) + "_head")
    victim_shard = next(s for s, o in enumerate(acting)
                        if o != primary and 0 <= o < N_OSDS)
    victim = acting[victim_shard]
    g = GHObject("atrest", shard=victim_shard)
    good = bcluster.osds[victim].store.read(coll, g)
    _flip_at_rest(bcluster.osds[victim].store, good)

    # the store itself must now refuse the read (crc32c-at-rest)
    with pytest.raises(Exception):
        bcluster.osds[victim].store.read(coll, g)

    errors = pg.scrub()
    assert "atrest" in errors, errors
    post = pg.repair()
    assert post.get("atrest") is None, post
    assert bcluster.osds[victim].store.read(coll, g) == good
    assert bclient.get(EC_POOL, "atrest") == payload
