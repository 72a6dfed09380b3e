"""``tests/test_cache_tier.py`` mirrored on the port's cluster: the
port's ``CacheTier`` (``ceph_tpu_torch/client/cache_tier.py``, over the
port's ``osd/hitset.py``) with the replicated pool as the cache and the
EC pool as the base: cold reads proxied, hot reads promoted, writeback,
flush, evict, the agent, and a remove of both copies.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), the client ``torch_daemon_harness.LibClient``.
"""

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.client.cache_tier import CacheTier
from ceph_tpu_torch.client.rados import RadosError

REP_POOL, EC_POOL = H.REP_POOL, H.EC_POOL


@pytest.fixture(scope="module")
def cluster():
    c = H.DaemonCluster("ceph_tpu_torch", device="cpu")
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    cl = H.LibClient(cluster)
    yield cl
    cl.shutdown()


@pytest.fixture
def tier(client):
    # cache = replicated pool, base = EC pool (the classic deployment)
    return CacheTier(client.rc.ioctx(REP_POOL), client.rc.ioctx(EC_POOL),
                     hit_set_period=0.05, min_recency_for_promote=2,
                     capacity_objects=10)


def test_cold_reads_proxy_hot_reads_promote(tier):
    tier.base.write_full("warmme", b"base-copy")
    # first read: cold -> proxied, not cached
    assert tier.read("warmme") == b"base-copy"
    assert tier.proxied == 1 and tier.promotes == 0
    assert "warmme" not in tier.cache.list_objects()
    # heat it up across hit-set periods
    import time

    for _ in range(3):
        time.sleep(0.06)
        got = tier.read("warmme")
        assert got == b"base-copy"
    assert tier.promotes == 1
    assert "warmme" in tier.cache.list_objects()


def test_writeback_flush_and_evict(tier):
    tier.write_full("wb", b"dirty-data")
    # base hasn't seen it yet (writeback)
    with pytest.raises(RadosError):
        tier.base.read("wb")
    tier.flush("wb")
    assert tier.base.read("wb") == b"dirty-data"
    tier.evict("wb")
    assert "wb" not in tier.cache.list_objects()
    assert tier.read("wb") == b"dirty-data"  # proxied from base


def test_evict_refuses_dirty(tier):
    tier.write_full("dirtyobj", b"x")
    with pytest.raises(RadosError):
        tier.evict("dirtyobj")
    tier.flush("dirtyobj")
    tier.evict("dirtyobj")


def test_agent_flushes_cold_dirty_and_evicts_cold_clean(tier):
    import time

    for i in range(6):
        tier.write_full(f"cold{i}", b"d" * 64)
    # make one object hot so the agent keeps it
    for _ in range(3):
        time.sleep(0.06)
        tier.read("cold0")
    res = tier.agent_work(max_ops=4)
    assert res["flushed"], "agent must flush cold dirty objects"
    assert "cold0" not in res["flushed"][:1], "hottest flushes last"
    for oid in res["flushed"]:
        assert tier.base.read(oid) == b"d" * 64
    n = tier.flush_all()
    res2 = tier.agent_work(max_ops=10)
    for oid in res2["evicted"]:
        assert oid not in tier.cache.list_objects()


def test_remove_removes_both_tiers(tier):
    tier.write_full("gone", b"x")
    tier.flush("gone")
    tier.remove("gone")
    with pytest.raises(RadosError):
        tier.base.read("gone")
    with pytest.raises(RadosError):
        tier.cache.read("gone")
