"""The port's lockdep (``ceph_tpu_torch/core/lockdep.py``), case for case
against ``tests/test_lockdep.py``.

``test_cluster_runs_clean_under_lockdep`` runs on the port's cluster,
``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")`` (six port
daemons, ``device="cpu"``), through the port's client, with the port's
lockdep on before any lock is made.
``test_runtime_edges_subset_of_static_graph`` waits: it needs a static
lock model of the port (queue 1 item 7).  The port's lockdep is its own module,
so arming it leaves the reference's untouched, and the reverse.
"""

import json
import threading

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.core import lockdep
from ceph_tpu_torch.core.lockdep import DMutex, LockOrderError, make_lock


@pytest.fixture(autouse=True)
def _lockdep_on():
    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    yield
    lockdep.enable(was)
    lockdep.reset()


def test_consistent_order_is_clean():
    a, b = DMutex("A"), DMutex("B")
    for _ in range(3):
        with a:
            with b:
                pass


def test_cycle_detected():
    a, b = DMutex("A"), DMutex("B")
    with a:
        with b:
            pass
    with pytest.raises(LockOrderError) as ei:
        with b:
            with a:
                pass
    assert "A" in str(ei.value) and "B" in str(ei.value)


def test_transitive_cycle_detected():
    a, b, c = DMutex("A"), DMutex("B"), DMutex("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(LockOrderError):
        with c:
            with a:
                pass


def test_reentrant_is_not_a_cycle():
    a = DMutex("A")
    with a:
        with a:  # re-entrancy must not self-edge
            pass


def test_per_thread_held_stacks():
    a, b = DMutex("A"), DMutex("B")
    errs = []

    def t1():
        try:
            with a:
                with b:
                    pass
        except LockOrderError as e:
            errs.append(e)

    th = threading.Thread(target=t1)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    assert not errs
    # the reverse order from THIS thread still trips on t1's edges
    with pytest.raises(LockOrderError):
        with b:
            with a:
                pass


def test_make_lock_plain_when_disabled():
    lockdep.enable(False)
    lk = make_lock("whatever")
    assert not isinstance(lk, DMutex)
    lockdep.enable(True)
    assert isinstance(make_lock("x"), DMutex)


def test_edge_graph_records_first_seen_sites(tmp_path):
    a, b = DMutex("A"), DMutex("B")
    with a:
        with b:
            pass
    g = lockdep.edge_graph()
    assert list(g) == ["A"] and list(g["A"]) == ["B"]
    # the first-seen site names THIS file
    assert "test_torch_lockdep.py" in g["A"]["B"]

    out = tmp_path / "edges.json"
    lockdep.dump(str(out))
    payload = json.loads(out.read_text())
    assert payload["enabled"] is True
    assert list(payload["edges"]["A"]) == ["B"]

    lockdep.reset()
    assert lockdep.edge_graph() == {}


def test_condition_over_a_checked_lock_keeps_the_held_stack():
    """Condition(make_lock(...)) — the staging pool's shape — waits and
    wakes with the held-lock bookkeeping intact on both threads."""
    pool = threading.Condition(make_lock("staging.pool"))
    stats = make_lock("staging.stats")
    ready = []

    def waiter():
        with pool:
            pool.wait_for(lambda: ready, timeout=10)
            with stats:
                pass

    th = threading.Thread(target=waiter)
    th.start()
    with pool:
        ready.append(True)
        pool.notify_all()
    th.join(timeout=10)
    assert not th.is_alive()
    g = lockdep.edge_graph()
    assert list(g) == ["staging.pool"]
    assert list(g["staging.pool"]) == ["staging.stats"]
    with pytest.raises(LockOrderError):
        with stats:
            with pool:
                pass


def test_cluster_runs_clean_under_lockdep():
    """``test_lockdep.py:97``: the write, read and failover paths of the
    port's cluster and client take their locks in one order, lockdep
    on from end to end."""
    REP_POOL, EC_POOL = H.REP_POOL, H.EC_POOL
    c = H.DaemonCluster("ceph_tpu_torch", device="cpu")
    cl = H.LibClient(c)
    try:
        cl.put(REP_POOL, "ld1", b"x" * 2000)
        assert cl.get(REP_POOL, "ld1") == b"x" * 2000
        cl.put(EC_POOL, "ld2", b"y" * 4096)
        assert cl.get(EC_POOL, "ld2") == b"y" * 4096
        _, acting, primary = c.primary_of(REP_POOL, "ld1")
        victim = next(o for o in acting if o != primary)
        c.kill(victim)
        cl.put(REP_POOL, "ld1", b"z" * 100)
        c.revive(victim)
        assert cl.get(REP_POOL, "ld1") == b"z" * 100
    finally:
        cl.shutdown()
        c.shutdown()
