"""The cluster cases of ``tests/test_device_datapath.py`` (``:188``
onward) mirrored on the port's cluster: an EC ``WRITEFULL`` burst
through the port's client stages every payload as a ``DeviceBuf``
(uploads each byte about once, never touches it on the host), ragged
sizes round-trip, each stored shard's ``hinfo`` CRC is the host CRC of
its bytes, and the kill switch ``CEPH_TPU_TPU_DEVPATH=0`` stores the
same shards.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``: the queue is ``default_queue("cpu")``), the client
``torch_daemon_harness.LibClient``.  The staging and CRC cases of that
file are mirrored in ``tests/test_torch_staging.py`` and
``tests/test_torch_crc32c.py``.
"""

import numpy as np
import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.gpu.queue import default_queue

EC_POOL = H.EC_POOL
LibClient = H.LibClient


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


# -- end-to-end through the cluster ------------------------------------------

@pytest.fixture(scope="module")
def ec_cluster():
    c = MiniCluster()
    cl = LibClient(c)
    yield c, cl
    cl.shutdown()
    c.shutdown()


def _stats():
    return default_queue("cpu").stats.snapshot()


def test_ec_writefull_device_path_happy_counters(ec_cluster):
    """The acceptance invariant, counter-measured: a happy-path EC
    WRITEFULL burst stages every payload (staged_batches > 0), uploads
    each payload byte about once (h2d <= 1.1x), and NEVER materializes
    payload bytes on host (payload_host_touches == 0)."""
    c, cl = ec_cluster
    rng = np.random.default_rng(0xD47A)
    payloads = {f"dp_{i}": rng.integers(0, 256, 4096, dtype=np.uint8)
                .tobytes() for i in range(12)}
    s0 = _stats()
    for oid, data in payloads.items():
        assert cl.put(EC_POOL, oid, data).result == 0
    s1 = _stats()
    total = sum(len(v) for v in payloads.values())
    assert s1["staged_batches"] > s0["staged_batches"]
    assert s1["payload_host_touches"] == s0["payload_host_touches"], (
        "payload bytes materialized on host during the happy path")
    h2d = s1["h2d_bytes"] - s0["h2d_bytes"]
    assert h2d <= 1.1 * total, (h2d, total)
    assert h2d >= total, "writes bypassed the staged upload"
    # bit-exactness, straight back through the read path
    for oid, data in payloads.items():
        assert bytes(cl.get(EC_POOL, oid)) == data


def test_ec_writefull_device_path_ragged_sizes(ec_cluster):
    """Non-stripe-aligned objects (ragged tails through interleave,
    crc, deinterleave) round-trip bit-exact."""
    c, cl = ec_cluster
    rng = np.random.default_rng(5)
    for n in (1, 3, 511, 2048, 3333, 4095, 4097, 9000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert cl.put(EC_POOL, f"rag_{n}", data).result == 0
        assert bytes(cl.get(EC_POOL, f"rag_{n}")) == data


def test_device_path_hinfo_crc_matches_stored_chunks(ec_cluster):
    """The fused on-device crc lands in each shard's HashInfo and must
    equal a host crc of the chunk bytes actually stored."""
    from ceph_tpu_torch.osd import types as ot
    from ceph_tpu_torch.osd.backend import hinfo_decode
    from ceph_tpu_torch.store.objectstore import Collection, GHObject
    c, cl = ec_cluster
    data = bytes(np.random.default_rng(9).integers(
        0, 256, 4096, dtype=np.uint8))
    oid = "hinfo_probe"
    assert cl.put(EC_POOL, oid, data).result == 0
    checked = 0
    for i, svc in c.osds.items():
        for pgid, pg in svc.pgs.items():
            if pgid[0] != EC_POOL:
                continue
            coll = Collection(ot.pgid_str(pgid) + "_head")
            for s in range(pg.backend.k + pg.backend.m):
                g = GHObject(oid, shard=s)
                if not svc.store.exists(coll, g):
                    continue
                chunk = svc.store.read(coll, g)
                size, crc, valid = hinfo_decode(
                    svc.store.getattr(coll, g, "hinfo"))
                assert valid and size == len(data)
                assert crc == crc32c(chunk), (i, s)
                checked += 1
    assert checked >= 3, "no shards found to verify"


def test_legacy_and_device_paths_store_identical_shards(monkeypatch):
    """CEPH_TPU_TPU_DEVPATH=0 must behave byte-identically: same
    read-back, same stored chunk bytes — the device path changes HOW
    bytes move, never WHAT lands."""
    from ceph_tpu_torch.osd import types as ot
    from ceph_tpu_torch.store.objectstore import Collection, GHObject

    def shard_map(devpath: str, payload: bytes):
        monkeypatch.setenv("CEPH_TPU_TPU_DEVPATH", devpath)
        c = MiniCluster()
        cl = LibClient(c)
        try:
            assert cl.put(EC_POOL, "ab_probe", payload).result == 0
            assert bytes(cl.get(EC_POOL, "ab_probe")) == payload
            out = {}
            for i, svc in c.osds.items():
                for pgid, pg in svc.pgs.items():
                    if pgid[0] != EC_POOL:
                        continue
                    coll = Collection(ot.pgid_str(pgid) + "_head")
                    for s in range(pg.backend.k + pg.backend.m):
                        g = GHObject("ab_probe", shard=s)
                        if svc.store.exists(coll, g):
                            out[(i, s)] = crc32c(svc.store.read(coll, g))
            return out
        finally:
            cl.shutdown()
            c.shutdown()

    payload = bytes(np.random.default_rng(11).integers(
        0, 256, 4096, dtype=np.uint8))
    dev = shard_map("1", payload)
    legacy = shard_map("0", payload)
    assert dev and dev == legacy
