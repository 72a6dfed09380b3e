"""The objecter's and the PG's cases of
``tests/test_concurrency_regressions.py`` on the port.

- ``Objecter._calc_target`` (``:39``) reads the client's map once a call,
  so a map swapped in by another thread never pairs a PG from one epoch
  with a primary from the next;
- a PG's boot-time loads (``:161``) hold the PG lock: a real port ``PG``
  over the stub host of ``tests/test_torch_recovery.py``.

The monitor's lease case (``:107``) waits for the port's monitor
(ROADMAP queue 1 item 6).
"""

import threading

from ceph_tpu_torch.client.objecter import Objecter
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
