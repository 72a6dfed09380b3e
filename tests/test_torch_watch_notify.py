"""``tests/test_watch_notify.py`` mirrored on the port's cluster:
watch registration, notify fan-out with acks, a dead watcher reported
missed within the timeout, and the objecter's linger re-registering a
watch on the new primary after a failover.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``); every client is the port's ``RadosClient``
(``torch_daemon_harness.LibClient``).
"""

import time

import pytest

import torch_daemon_harness as H

REP_POOL = H.REP_POOL
LibClient = H.LibClient


@pytest.fixture(scope="module")
def cluster():
    c = H.DaemonCluster("ceph_tpu_torch", device="cpu")
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    cl = LibClient(cluster)
    yield cl
    cl.shutdown()


def test_watch_notify_roundtrip(cluster, client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("watched", b"payload")
    got = []

    def cb(notify_id, payload):
        got.append(payload)
        return b"ack-from-w1"

    cookie = io.watch("watched", cb)
    acks, missed = io.notify("watched", b"hello-watchers")
    assert got == [b"hello-watchers"]
    assert list(acks.values()) == [b"ack-from-w1"]
    assert list(acks.keys())[0].endswith(f":{cookie}")
    assert missed == []
    io.unwatch(cookie)
    # after unwatch: no deliveries, no acks
    acks, missed = io.notify("watched", b"again", timeout_ms=1000)
    assert acks == {} and missed == []
    assert got == [b"hello-watchers"]


def test_multiple_watchers_all_ack(cluster, client):
    """A second client watching the same object also gets the notify."""
    io1 = client.rc.ioctx(REP_POOL)
    io1.write_full("shared-w", b"x")
    cl2 = LibClient(cluster)
    try:
        io2 = cl2.rc.ioctx(REP_POOL)
        seen = {"a": 0, "b": 0}
        c1 = io1.watch("shared-w", lambda n, p: (
            seen.__setitem__("a", seen["a"] + 1), b"A")[1])
        c2 = io2.watch("shared-w", lambda n, p: (
            seen.__setitem__("b", seen["b"] + 1), b"B")[1])
        acks, missed = io1.notify("shared-w", b"fanout")
        assert seen == {"a": 1, "b": 1}
        assert set(acks.values()) == {b"A", b"B"} and not missed
        io1.unwatch(c1)
        io2.unwatch(c2)
    finally:
        cl2.shutdown()


def test_notify_timeout_reports_dead_watcher(cluster, client):
    """A watcher that dies without unwatching shows up as missed, and
    the notify still completes within the timeout."""
    io = client.rc.ioctx(REP_POOL)
    io.write_full("deadw", b"x")
    cl2 = LibClient(cluster)
    io2 = cl2.rc.ioctx(REP_POOL)
    cookie = io2.watch("deadw", lambda n, p: b"never")
    cl2.shutdown()  # dies holding the watch
    t0 = time.time()
    acks, missed = io.notify("deadw", b"anyone?", timeout_ms=1500)
    assert time.time() - t0 < 10
    # either the reset pruned the watcher (no targets at all) or the
    # timeout reported it missed — never a hang, never a fake ack
    assert acks == {}
    if missed:
        assert len(missed) == 1 and missed[0].endswith(f":{cookie}")


def test_watch_survives_primary_failover(cluster, client):
    """The objecter linger re-registers the watch on the new primary."""
    io = client.rc.ioctx(REP_POOL)
    io.write_full("fow", b"x")
    got = []
    cookie = io.watch("fow", lambda n, p: (got.append(p), b"ok")[1])
    _, acting, primary = cluster.primary_of(REP_POOL, "fow")
    cluster.kill(primary)
    try:
        # allow the linger resend to land on the new primary
        deadline = time.time() + 10
        while time.time() < deadline:
            acks, _ = io.notify("fow", b"post-failover",
                                timeout_ms=2000)
            if acks:
                break
            time.sleep(0.3)
        assert list(acks.values()) == [b"ok"]
        assert b"post-failover" in got
    finally:
        io.unwatch(cookie)
        cluster.revive(primary)
