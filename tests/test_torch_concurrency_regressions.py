"""The objecter's and the PG's cases of
``tests/test_concurrency_regressions.py`` on the port.

- ``Objecter._calc_target`` (``:39``) reads the client's map once a call,
  so a map swapped in by another thread never pairs a PG from one epoch
  with a primary from the next;
- a PG's boot-time loads (``:161``) hold the PG lock: a real port ``PG``
  over the stub host of ``tests/test_torch_recovery.py``;
- the leader's lease (``:107``): a port ``Monitor`` stub whose tick
  loop sends leases while another thread commits, every lease's value
  the one of the version in its header.
"""

import threading
import time
from types import SimpleNamespace

from ceph_tpu_torch.client.objecter import Objecter
from ceph_tpu_torch.mon.monitor import STATE_LEADER, Monitor
from test_torch_recovery import _stub_pg


# -- Objecter._calc_target: torn osdmap double-read --------------------------

class _TaggedMap:
    """An osdmap stub that detects tearing: pg_to_up_acting refuses a
    pgid computed by a different epoch's map."""

    def __init__(self, tag: str, primary: int) -> None:
        self.tag = tag
        self.primary = primary

    def object_to_pg(self, pool, oid):
        return (self.tag, pool, oid)

    def pg_to_up_acting(self, pgid):
        assert pgid[0] == self.tag, (
            f"torn read: pgid from map {pgid[0]!r} resolved against "
            f"map {self.tag!r}")
        return ([self.primary], self.primary, [self.primary], self.primary)


def test_calc_target_uses_one_map_snapshot():
    obj = object.__new__(Objecter)
    m1, m2 = _TaggedMap("e1", 1), _TaggedMap("e2", 2)
    obj.osdmap = m1
    stop = threading.Event()

    def flip():
        while not stop.is_set():
            obj.osdmap = m2
            obj.osdmap = m1

    th = threading.Thread(target=flip, daemon=True)
    th.start()
    try:
        for _ in range(5000):
            pgid, primary = obj._calc_target(3, "oid")
            # the pair must be coherent with a single map
            assert (pgid[0], primary) in (("e1", 1), ("e2", 2))
    finally:
        stop.set()
        th.join()


# -- PG boot-time loads hold the pg lock -------------------------------------

def _probe_store(real, pg, calls):
    class Probe:
        def __getattr__(self, name):
            attr = getattr(real, name)
            if not callable(attr):
                return attr

            def wrapped(*a, **kw):
                calls.append((name, pg.lock._is_owned()))
                return attr(*a, **kw)
            return wrapped
    return Probe()


def test_pg_boot_loads_hold_the_pg_lock():
    """load_from_store()/create_onstore() mutate info/log/acting that
    every other lane reads under pg.lock, so the loads hold it too."""
    pg, osd = _stub_pg("ceph_tpu_torch",
                       "plugin=isa k=2 m=1 technique=reed_sol_van",
                       acting=[0, 1, 2], kind="pg")
    calls = []
    osd.store = _probe_store(osd.store, pg, calls)
    pg.create_onstore()
    pg.load_from_store()
    assert calls, "probe saw no store traffic during boot load"
    unlocked = [name for name, owned in calls if not owned]
    assert not unlocked, (
        f"store accessed WITHOUT pg.lock during boot load: {unlocked}")


# -- Monitor lease: pn/version/value snapshot --------------------------------

class _Conf:
    def __init__(self, vals):
        self._v = vals

    def get(self, key):
        return self._v[key]


class _KV:
    """paxos_values table keyed by stringified version."""

    def __init__(self):
        self.vals = {"0": b"v0"}

    def get(self, table, key):
        assert table == "paxos_values"
        return self.vals.get(key)


def _lease_mon(captured):
    mon = object.__new__(Monitor)
    mon.ctx = SimpleNamespace(conf=_Conf({
        "mon_tick_interval": 0.0005,
        "mon_lease": 1.0,
        "mon_osd_down_out_interval": 600.0,
    }))
    mon._stop = threading.Event()
    mon.lock = threading.RLock()
    mon.state = STATE_LEADER
    mon._catchup_want = 0
    mon.rank = 0
    mon.accepted_pn = 1
    mon.last_committed = 0
    mon.kv = _KV()
    mon.osdmap = None  # _osd_tick returns early (under the lock)
    mon.services = {"health": SimpleNamespace(tick=lambda: None)}
    mon._peers = lambda: [1]
    mon._send_mon = lambda rank, msg: captured.append(
        (msg.version, bytes(msg.value)))
    mon._log = lambda *a, **kw: None
    return mon


def test_leader_lease_is_coherent_under_concurrent_commits():
    """A lease's (version, value) pair comes from one lock hold: a
    commit landing between two reads would send a lease whose value
    belongs to another version than its header claims."""
    captured = []
    mon = _lease_mon(captured)
    ticker = threading.Thread(target=mon._tick_loop, daemon=True)
    ticker.start()

    stop = threading.Event()

    def commit_loop():
        while not stop.is_set():
            with mon.lock:
                ver = mon.last_committed + 1
                mon.kv.vals[str(ver)] = f"v{ver}".encode()
                mon.last_committed = ver

    bumper = threading.Thread(target=commit_loop, daemon=True)
    bumper.start()
    try:
        deadline = time.monotonic() + 10.0
        while len(captured) < 50 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        mon._stop.set()
        bumper.join()
        ticker.join(timeout=5)
    assert len(captured) >= 50, "leader never ticked enough leases"
    for ver, value in captured:
        assert value == f"v{ver}".encode(), (
            f"torn lease: header says version {ver} but payload is "
            f"{value!r}")
