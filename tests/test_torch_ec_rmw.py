"""The cluster cases of ``tests/test_ec_rmw.py`` (``:39``, ``:85``)
mirrored on the port's cluster: a partial-stripe EC overwrite through
the port's client moves only the touched stripes, and still works with
a shard holder down (the old stripes decoded from the survivors).

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), the client ``torch_daemon_harness.LibClient``.  The
backend-level cases of that file (the extent cache's pipelining and the
hinfo round trip) are mirrored in ``tests/test_torch_backend.py``.
"""

import numpy as np
import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_

EC_POOL = H.EC_POOL


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


def test_partial_overwrite_moves_only_touched_stripes(cluster, client):
    """A ranged overwrite inside a large EC object ships per-shard
    extents far smaller than the full object re-encode."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=256 * 1024, dtype=np.uint8).tobytes()
    client.put(EC_POOL, "rmw1", data)

    pgid, acting, primary = cluster.primary_of(EC_POOL, "rmw1")
    pg = cluster.osds[primary].pgs[pgid]
    be = pg.backend

    sent_bytes = []
    orig_send = be.osd_send

    def spy(osd, msg):
        if isinstance(msg, (m.MECSubWrite, m.MECSubWriteVec)):
            sent_bytes.append(len(msg.txn))
        orig_send(osd, msg)

    be.osd_send = spy
    try:
        patch = b"\xab" * 100
        off = 10_000
        rep = client.op(EC_POOL, "rmw1",
                        [t_.OSDOp(t_.OP_WRITE, off=off, data=patch)])
        assert rep.result == 0
    finally:
        be.osd_send = orig_send

    got = client.get(EC_POOL, "rmw1")
    want = data[:off] + patch + data[off + len(patch):]
    assert got == want, "partial overwrite corrupted the object"
    # the patch spans ceil(100 / (k*unit)) + alignment stripes; each
    # shard extent is stripes*unit bytes — orders of magnitude below
    # the 128 KiB full-object chunk
    assert sent_bytes, "no sub-writes captured"
    width = be.stripe_width
    max_stripes = (off + len(patch) - 1) // width - off // width + 1
    bound = max_stripes * be.unit + 4096  # txn framing + log omap slack
    for n in sent_bytes:
        assert n < bound, (
            f"sub-write txn {n}B exceeds touched-stripe bound {bound}B "
            "(full re-encode would be ~128KiB)"
        )


def test_partial_overwrite_degraded(cluster, client):
    """RMW still works when a shard holder is down (old stripes are
    decoded from survivors)."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=64 * 1024, dtype=np.uint8).tobytes()
    client.put(EC_POOL, "rmw2", data)
    pgid, acting, primary = cluster.primary_of(EC_POOL, "rmw2")
    victim = next(o for o in acting if o != primary and o >= 0)
    cluster.kill(victim)
    try:
        patch = b"\xcd" * 4096
        off = 20_000
        rep = client.op(EC_POOL, "rmw2",
                        [t_.OSDOp(t_.OP_WRITE, off=off, data=patch)],
                        timeout=20.0)
        assert rep.result == 0
        got = client.get(EC_POOL, "rmw2")
        assert got == data[:off] + patch + data[off + len(patch):]
    finally:
        cluster.revive(victim)
