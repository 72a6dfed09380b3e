"""The port's dmClock queue and QoS scheduler (``ceph_tpu_torch/osd/
{mclock,qos}.py``), case for case against ``tests/test_qos_tracking.py``
(``:30-381``: the 11 mclock cases, the standalone mclock workqueue end
to end among them, and the 6 qos cases), plus a cross-check: under one
fake clock both packages' ``MClockQueue`` dequeue one seeded sequence of
enqueues in the same order with the same phases, and both
``QosScheduler``s classify and cost one list of ``MOSDOp``s alike.

The reference's cluster-level cases (``:383-660``) run on the port's
cluster, ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")`` (six
port daemons, the reference's map,
``device="cpu"``), each tenant a port ``RadosClient``: the
per-connection message cap's stalls, the fifo arm serving, and the
OpTracker trail of a client op; with them the OpTracker unit cases of
that file (``:604-637``).  Left out: the two-tenant starvation
regression (``:460``; on the port's CPU cluster its margin does not
hold: the second run in one process saw the reserved trickle take 1.2 s
and the flood drain first, ROADMAP 1k) and its fifo arm (marked slow
there).  The mgr's ``qos`` module (``:554``) is mirrored in
``tests/test_torch_mgr.py``.
"""

import time

import numpy as np
import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.core.optracker import OpTracker
from ceph_tpu_torch.core.workqueue import ShardedWorkQueue, _prio_to_class
from ceph_tpu_torch.osd.mclock import ClientInfo, MClockQueue


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_mclock_reservation_floor():
    """A class with a reservation gets its floor even when a heavier
    class floods the queue."""
    clk = FakeClock()
    q = MClockQueue({
        "flood": ClientInfo(reservation=0.0, weight=100.0, limit=0.0),
        "guaranteed": ClientInfo(reservation=10.0, weight=1.0, limit=0.0),
    }, clock=clk)
    for i in range(1000):
        q.enqueue("flood", f"f{i}")
    for i in range(10):
        q.enqueue("guaranteed", f"g{i}")
    # run exactly one simulated second of dispatch at 100 ops/sec
    served = {"flood": 0, "guaranteed": 0}
    for i in range(100):
        clk.t = i / 100.0
        cls, _ = q.dequeue()
        served[cls] += 1
    # 10 ops/s reservation -> the floor is honored across the second
    # (the 10th tag lands exactly AT t=1.0, one tick past the loop)
    assert served["guaranteed"] >= 9, served


def test_mclock_weight_proportionality():
    clk = FakeClock()
    q = MClockQueue({
        "heavy": ClientInfo(weight=30.0),
        "light": ClientInfo(weight=10.0),
    }, clock=clk)
    for i in range(400):
        q.enqueue("heavy", i)
        q.enqueue("light", i)
    served = {"heavy": 0, "light": 0}
    for i in range(200):
        clk.t = i / 1000.0
        cls, _ = q.dequeue()
        served[cls] += 1
    ratio = served["heavy"] / max(served["light"], 1)
    assert 2.0 < ratio < 4.5, served  # ~3x by weight


def test_mclock_limit_throttles_but_work_conserves():
    clk = FakeClock()
    q = MClockQueue({
        "capped": ClientInfo(weight=100.0, limit=10.0),
        "open": ClientInfo(weight=1.0, limit=0.0),
    }, clock=clk)
    for i in range(100):
        q.enqueue("capped", i)
        q.enqueue("open", i)
    served = {"capped": 0, "open": 0}
    for i in range(100):
        clk.t = i / 100.0  # one second total
        cls, _ = q.dequeue()
        served[cls] += 1
    # despite 100x weight, the cap holds capped to ~10 in the second
    # and the remaining capacity goes to the open class (work
    # conservation keeps total == 100)
    assert served["capped"] <= 15, served
    assert served["capped"] + served["open"] == 100
    # drain empty
    while len(q):
        q.dequeue()
    assert q.dequeue() is None


def test_mclock_fifo_within_class():
    q = MClockQueue({"c": ClientInfo(weight=1.0)})
    for i in range(5):
        q.enqueue("c", i)
    assert [q.dequeue()[1] for _ in range(5)] == [0, 1, 2, 3, 4]


def test_workqueue_mclock_scheduler_end_to_end():
    done = []
    wq = ShardedWorkQueue("t", 1, process=lambda item: done.append(item),
                          scheduler="mclock")
    wq.start()
    for i in range(20):
        wq.queue("pg1", ("client", i), priority=63, qos_class="client")
        wq.queue("pg1", ("rec", i), priority=3, qos_class="recovery")
    assert wq.drain(10.0)
    wq.stop()
    assert len(done) == 40
    # client ops must not starve behind recovery
    first_client = next(i for i, d in enumerate(done) if d[0] == "client")
    assert first_client < 10


def test_prio_class_mapping():
    assert _prio_to_class(63) == "client"
    assert _prio_to_class(10) == "osd_subop"
    assert _prio_to_class(3) == "recovery"
    assert _prio_to_class(1) == "scrub"


# -- scheduler conformance ----------------------------------------------------

def test_mclock_cost_aware_tags():
    """Byte-honest charging: at equal weight, a tenant of 16-unit ops
    (64KiB) is served ~16x fewer OPS than a 1-unit (4KiB) tenant —
    equal BYTES, not equal op counts."""
    clk = FakeClock()
    q = MClockQueue({
        "big": ClientInfo(weight=100.0),
        "small": ClientInfo(weight=100.0),
    }, clock=clk)
    for i in range(200):
        q.enqueue("big", i, cost=16.0)
        q.enqueue("small", i, cost=1.0)
    served = {"big": 0, "small": 0}
    for i in range(170):
        clk.t = i / 100.0
        cls, _ = q.dequeue()
        served[cls] += 1
    ratio = served["small"] / max(served["big"], 1)
    assert 10.0 < ratio < 22.0, served  # ~16x by cost


def test_mclock_idle_reanchor():
    """After an idle gap, tags re-anchor to now: the first op is due
    AT now (the class doesn't lose a slot per idle restart), and the
    gap is never replayed as credit (a post-idle burst earns ONE
    instantly-due reservation grant, not one per idle second)."""
    clk = FakeClock()
    q = MClockQueue({
        "res": ClientInfo(reservation=10.0, weight=1.0),
        "flood": ClientInfo(reservation=0.0, weight=1000.0),
    }, clock=clk)
    q.enqueue("res", "warm")
    assert q.dequeue() == ("res", "warm")
    clk.t = 100.0  # 100 s idle: 1000 reservation slots' worth of gap
    for i in range(200):
        q.enqueue("flood", f"f{i}")
    for i in range(20):
        q.enqueue("res", f"r{i}")
    # at exactly t=100 the reserved class has ONE due tag — re-anchored
    # to now (not now + 1/r: that would dock the restart), and not 20+
    # (the idle gap must not have accumulated as credit)
    served_now = 0
    for _ in range(10):
        cls, _item = q.dequeue()
        if cls == "res":
            served_now += 1
    assert served_now == 1, served_now
    # over the next second the 10/s floor pays out exactly on schedule
    served = served_now
    for i in range(1, 101):
        clk.t = 100.0 + i / 100.0
        cls, _item = q.dequeue()
        if cls == "res":
            served += 1
    assert 10 <= served <= 12, served


def test_mclock_dequeue_phase_evidence():
    clk = FakeClock()
    q = MClockQueue({
        "res": ClientInfo(reservation=100.0, weight=1.0),
        "open": ClientInfo(reservation=0.0, weight=10.0),
        "capped": ClientInfo(reservation=0.0, weight=10.0, limit=1.0),
    }, clock=clk)
    q.enqueue("res", 1)
    clk.t = 1.0  # reservation tag due
    assert q.dequeue()[0] == "res" and q.last_phase == "reservation"
    q.enqueue("open", 2)
    clk.t = 1.001  # open's p_tag not due as a reservation (none set)
    assert q.dequeue()[0] == "open" and q.last_phase == "priority"
    q.enqueue("capped", 3)
    q.enqueue("capped", 4)
    clk.t = 1.5
    q.dequeue()  # first capped op is limit-eligible by t=1.5
    clk.t = 1.9  # second's limit tag (~2.0) is still in the future
    assert q.dequeue()[0] == "capped" and q.last_phase == "fallback"


def test_mclock_runtime_retune():
    """set_class retunes future tag advancement (the `qos set` path)."""
    clk = FakeClock()
    q = MClockQueue({
        "a": ClientInfo(weight=10.0),
        "b": ClientInfo(weight=10.0),
    }, clock=clk)
    q.set_class("a", ClientInfo(weight=100.0))
    for i in range(200):
        q.enqueue("a", i)
        q.enqueue("b", i)
    served = {"a": 0, "b": 0}
    for i in range(110):
        clk.t = i / 1000.0
        cls, _ = q.dequeue()
        served[cls] += 1
    assert served["a"] / max(served["b"], 1) > 5.0, served


def test_mclock_resolver_unknown_class():
    """Unknown classes resolve through the registry callback (tenant
    classes minted at first enqueue), not a silent best_effort."""
    clk = FakeClock()
    got = []

    def resolver(name):
        got.append(name)
        return ClientInfo(reservation=50.0, weight=50.0)

    q = MClockQueue({"client": ClientInfo(weight=1.0)}, clock=clk,
                    resolver=resolver)
    q.enqueue("client/client.9", "x")
    assert got == ["client/client.9"]
    assert q.class_info()["client/client.9"].reservation == 50.0


# -- profile registry + feedback controller (osd/qos.py) ---------------------

def test_qos_profile_spec_parse_and_merge():
    from ceph_tpu_torch.osd.qos import (QosProfileRegistry, merge_profile_spec,
                                  parse_profile_spec)

    spec = "client=500:100:0;tenant:client.7=50:50:0;pool:3=10:5:100"
    reg = QosProfileRegistry(spec)
    assert reg.classes["client"].reservation == 500.0
    assert reg.resolve("client", tenant="client.7") == "client/client.7"
    assert reg.resolve("client", tenant="client.8", pool=3) == "pool/3"
    assert reg.resolve("client", tenant="client.8", pool=9) == "client"
    assert reg.resolve("snaptrim", tenant="client.7") == "snaptrim"
    assert reg.info_for("client/client.7").reservation == 50.0
    assert reg.info_for("pool/3").limit == 100.0
    # merge: one-target retune keeps the rest of the spec intact
    merged = merge_profile_spec(spec, "tenant:client.7", 80, 80, 0)
    reg2 = QosProfileRegistry(merged)
    assert reg2.info_for("client/client.7").reservation == 80.0
    assert reg2.classes["client"].reservation == 500.0
    with pytest.raises(ValueError):
        parse_profile_spec("not-a-spec")
    with pytest.raises(ValueError):
        parse_profile_spec("nosuchclass=1:1:1")
    # a non-integer pool id must die at PARSE time: apply_spec resets
    # the registry before rebuilding, so a mid-rebuild failure would
    # wipe every live override (review find)
    with pytest.raises(ValueError):
        parse_profile_spec("pool:abc=1:1:1")
    # merge output must round-trip: %g serializes tiny floats in
    # e-notation, and conf commits the value BEFORE observers validate
    # — an unparseable merged spec would poison osd_qos_profiles
    tiny = merge_profile_spec("", "client", 1e-05, 1, 0)
    assert parse_profile_spec(tiny)[0][1].reservation == 1e-05
    with pytest.raises(ValueError):
        merge_profile_spec("", "bogusclass", 1, 1, 1)


def test_qos_snaptrim_bucket_bounds_debt():
    """The snaptrim pacer caps each pause; the bucket must bound its
    banked debt, or one long sweep throttles every later idle-cluster
    sweep against minutes of phantom debt (review find)."""
    from ceph_tpu_torch.osd.qos import _TokenBucket

    clk = FakeClock()
    b = _TokenBucket(2.0, clock=clk)  # 0.5 s per charge
    for _ in range(100):  # caller pauses less than it is charged
        b.charge(1.0)
    # debt is clamped: the next charge after the bound elapses is free
    clk.t = _TokenBucket.MAX_DEBT_S + 0.5
    assert b.charge(1.0) == 0.0


def test_qos_recovery_feedback_controller():
    from ceph_tpu_torch.core.config import Config
    from ceph_tpu_torch.osd.qos import QosScheduler

    conf = Config({"osd_recovery_max_active": 3})
    rate = [0.0]
    s = QosScheduler(conf, clock=FakeClock(),
                     client_rate_fn=lambda: rate[0])
    # clients idle: the window widens by the conf multiplier
    assert s.recovery_window(3) == 12
    s.note_recovery_grant(12)
    # client pressure: clamped to half
    rate[0] = 100.0
    assert s.recovery_window(3) == 1  # max(1, 3//2)... floor holds
    rate[0] = 60.0
    assert s.recovery_window(4) == 2
    s.note_recovery_grant(2)
    # in between: the conf window as-is
    rate[0] = 10.0
    assert s.recovery_window(3) == 3
    st = s.status()
    assert st["recovery"]["widened"] == 12
    assert st["recovery"]["clamped"] == 2
    # feedback off: always the base window
    conf.set_val("osd_recovery_feedback", False)
    rate[0] = 0.0
    assert s.recovery_window(3) == 3


def test_qos_local_pressure_ring():
    """Without a wired digest fn the controller reads its own
    admitted-client-ops ring (the same counter family the PGMap
    digest rates derive from)."""
    from ceph_tpu_torch.core.config import Config
    from ceph_tpu_torch.osd.qos import QosScheduler

    clk = FakeClock()
    conf = Config()
    s = QosScheduler(conf, clock=clk)
    assert s.client_iops() == 0.0
    for i in range(100):
        clk.t = i / 100.0
        s.note_admit("client")
    assert 80.0 < s.client_iops() < 120.0
    # and a cold ring decays to zero once pushes stop
    clk.t = 60.0
    assert s.client_iops() == 0.0


def test_qos_classify_op_cost_and_tenant():
    from ceph_tpu_torch.core.config import Config
    from ceph_tpu_torch.msg.message import EntityName
    from ceph_tpu_torch.osd import messages as m
    from ceph_tpu_torch.osd import types as t_
    from ceph_tpu_torch.osd.qos import QosScheduler

    conf = Config({"osd_qos_profiles": "tenant:client.7=50:50:0"})
    s = QosScheduler(conf, clock=FakeClock())
    op = m.MOSDOp((1, 0), 1, "o", [t_.OSDOp(t_.OP_WRITEFULL,
                                            data=b"x" * 65536)])
    op.src = EntityName("client", 7)
    qcls, cost = s.classify_op(op)
    assert qcls == "client/client.7" and cost == 16.0
    op.src = EntityName("client", 8)
    qcls, cost = s.classify_op(op)
    assert qcls == "client" and cost == 16.0
    trim = m.MOSDOp((1, 0), 1, "o", [t_.OSDOp(t_.OP_SNAPTRIM, off=1)])
    trim.src = EntityName("client", 8)
    assert s.classify_op(trim)[0] == "snaptrim"
    rd = m.MOSDOp((1, 0), 1, "o", [t_.OSDOp(t_.OP_READ, length=8192)])
    rd.src = EntityName("client", 8)
    assert s.classify_op(rd)[1] == 2.0


def test_qos_scheduler_reload_updates_live_queues():
    from ceph_tpu_torch.core.config import Config
    from ceph_tpu_torch.osd.qos import QosScheduler

    conf = Config()
    s = QosScheduler(conf, clock=FakeClock())
    q = s.make_shard_queue()
    assert q.class_info()["client"].reservation == 100.0
    s.reload("client=42:42:0")
    assert q.class_info()["client"].reservation == 42.0
    s.set_class("tenant:client.5", 7, 7, 0)
    assert s.registry.info_for("client/client.5").weight == 7.0


# -- cross-checks against ceph_tpu --------------------------------------------

def _dequeue_order(mod, seed: int):
    """One seeded run of enqueues (classes, costs) interleaved with
    dequeues on ``mod``'s MClockQueue under a fake clock."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    q = mod.MClockQueue({
        "client": mod.ClientInfo(reservation=50.0, weight=100.0),
        "recovery": mod.ClientInfo(reservation=5.0, weight=10.0,
                                   limit=40.0),
        "scrub": mod.ClientInfo(reservation=1.0, weight=5.0, limit=20.0),
        "best_effort": mod.ClientInfo(weight=1.0),
    }, clock=clk, resolver=lambda name: mod.ClientInfo(
        reservation=20.0, weight=30.0, limit=200.0))
    classes = ["client", "recovery", "scrub", "best_effort",
               "client/client.7", "pool/3"]
    out = []
    for step in range(600):
        clk.t = step / 20.0
        for _ in range(int(rng.integers(0, 3))):
            cls = classes[int(rng.integers(0, len(classes)))]
            q.enqueue(cls, (cls, step), cost=float(rng.integers(1, 9)))
        if len(q) and rng.random() < 0.7:
            cls, item = q.dequeue()
            out.append((cls, item, q.last_phase))
    while len(q):
        clk.t += 0.01
        cls, item = q.dequeue()
        out.append((cls, item, q.last_phase))
    return out, q.stats(), sorted(q.class_info())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mclock_queue_dequeues_as_the_reference(seed):
    from ceph_tpu.osd import mclock as ref_mclock
    from ceph_tpu_torch.osd import mclock

    got = _dequeue_order(mclock, seed)
    want = _dequeue_order(ref_mclock, seed)
    assert got == want
    phases = {p for _c, _i, p in got[0]}
    assert {"reservation", "priority"} <= phases, phases


def test_qos_schedulers_classify_and_cost_alike():
    from ceph_tpu.core.config import Config as RefConfig
    from ceph_tpu.msg.message import EntityName as RefEntityName
    from ceph_tpu.osd import messages as ref_m
    from ceph_tpu.osd import types as ref_t
    from ceph_tpu.osd.qos import QosScheduler as RefQosScheduler
    from ceph_tpu_torch.core.config import Config
    from ceph_tpu_torch.msg.message import EntityName
    from ceph_tpu_torch.osd import messages as m
    from ceph_tpu_torch.osd import types as t_
    from ceph_tpu_torch.osd.qos import QosScheduler

    spec = "client=500:100:0;tenant:client.7=50:50:0;pool:3=10:5:100"
    rng = np.random.default_rng(13)

    def ops(mm, tt, EN):
        out = []
        for i in range(40):
            kind = int(rng.integers(0, 5))
            n = int(rng.integers(0, 200_000))
            if kind == 0:
                o = [tt.OSDOp(tt.OP_WRITEFULL, data=b"w" * n)]
            elif kind == 1:
                o = [tt.OSDOp(tt.OP_READ, length=n)]
            elif kind == 2:
                o = [tt.OSDOp(tt.OP_SNAPTRIM, off=1)]
            elif kind == 3:
                o = [tt.OSDOp(tt.OP_WRITE, off=7, data=b"p" * (n % 9000)),
                     tt.OSDOp(tt.OP_SETXATTR, name="a", data=b"v")]
            else:
                o = [tt.OSDOp(tt.OP_STAT)]
            msg = mm.MOSDOp((int(rng.integers(1, 5)), 0), 1, f"o{i}", o)
            msg.src = EN("client", int(rng.integers(6, 9)))
            out.append(msg)
        return out

    state = rng.bit_generator.state
    mine = ops(m, t_, EntityName)
    rng.bit_generator.state = state
    theirs = ops(ref_m, ref_t, RefEntityName)
    s = QosScheduler(Config({"osd_qos_profiles": spec}), clock=FakeClock())
    r = RefQosScheduler(RefConfig({"osd_qos_profiles": spec}),
                        clock=FakeClock())
    got = [s.classify_op(x) for x in mine]
    want = [r.classify_op(x) for x in theirs]
    assert got == want
    assert {c for c, _ in got} >= {"client", "client/client.7", "pool/3",
                                   "snaptrim"}
    for (c, cost), x in zip(got, mine):
        s.note_admit(c, cost)
    for (c, cost), x in zip(want, theirs):
        r.note_admit(c, cost)
    assert s.status()["classes"] == r.status()["classes"]


REP_POOL = H.REP_POOL
LibClient = H.LibClient


def MiniCluster(overrides=None):
    return H.DaemonCluster("ceph_tpu_torch", overrides=overrides,
                           device="cpu")


# -- cluster-level QoS (deterministic, failpoint-driven) ---------------------

def _tenant_client(cluster, num):
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.msg.message import EntityName

    rc = RadosClient(cluster.ctx, name=EntityName("client", num),
                     device="cpu")
    book = {i: o.addr for i, o in cluster.osds.items() if o.up}
    rc.inject_osdmap(cluster.osdmap, book)
    return rc


def test_edge_backpressure_throttle_stall():
    """osd_client_message_cap: with a 2-op per-connection cap, a
    40-deep flood queues at ITS socket — the messenger's dispatch gate
    records throttle_stall waits — and every op still completes."""
    from ceph_tpu_torch.osd import types as t_

    c = MiniCluster(overrides={"osd_client_message_cap": 2})
    cl = _tenant_client(c, 55)
    try:
        io = cl.ioctx(REP_POOL)
        pend = [io.aio_operate(
            f"thr_{i}", [t_.OSDOp(t_.OP_WRITEFULL, data=b"t" * 8192)],
            timeout=60.0) for i in range(40)]
        assert all(p.result(60.0).result == 0 for p in pend)
        stalls = sum(svc.msgr.perf.dump().get("throttle_stall", 0)
                     for svc in c.osds.values())
        assert stalls > 0, "40-deep flood under a 2-op cap never " \
            "stalled the gate"
        st = c.osds[0].qos.status(msgr_perf=c.osds[0].msgr.perf)
        assert st["throttle"]["message_cap"] == 2
    finally:
        cl.shutdown()
        c.shutdown()


def test_fifo_ab_arm_still_serves():
    """The A/B arm: osd_op_queue=fifo keeps the full op path working
    (the bench parity comparison depends on both arms being real)."""
    c = MiniCluster(overrides={"osd_op_queue": "fifo"})
    cl = LibClient(c)
    try:
        cl.put(REP_POOL, "fifo_obj", b"f" * 4096)
        assert cl.get(REP_POOL, "fifo_obj") == b"f" * 4096
        _pg, _acting, prim = c.primary_of(REP_POOL, "fifo_obj")
        st = c.osds[prim].qos.status()
        assert st["scheduler"] == "fifo"
        assert st["dequeue_phases"]["fifo"] > 0
    finally:
        cl.shutdown()
        c.shutdown()


# -- OpTracker ---------------------------------------------------------------

def test_optracker_lifecycle_and_dumps():
    tr = OpTracker(slow_op_threshold=0.05)
    op = tr.create_op("osd_op(client.1 tid=1 obj)")
    op.mark_event("queued")
    dump = tr.dump_in_flight()
    assert dump["num_ops"] == 1
    assert dump["ops"][0]["description"].startswith("osd_op")
    assert any(e["event"] == "queued" for e in dump["ops"][0]["events"])
    op.finish()
    assert tr.dump_in_flight()["num_ops"] == 0
    hist = tr.dump_historic()
    assert hist["num_ops"] == 1
    assert hist["ops"][0]["events"][-1]["event"] == "done"
    # fast op: not slow
    assert tr.dump_slow()["num_ops"] == 0


def test_optracker_slow_op_capture():
    tr = OpTracker(slow_op_threshold=0.01)
    op = tr.create_op("slow one")
    time.sleep(0.03)
    op.finish()
    slow = tr.dump_slow()
    assert slow["num_ops"] == 1 and tr.slow_ops == 1


def test_optracker_context_manager_and_bounds():
    tr = OpTracker(history_size=5)
    for i in range(12):
        with tr.create_op(f"op{i}") as op:
            op.mark_event("x")
    assert tr.dump_historic()["num_ops"] == 5  # bounded ring
    assert tr.ops_tracked == 12


def test_daemon_tracks_client_ops():
    """Cluster-level: a client op leaves an OpTracker trail on the
    primary."""
    c = MiniCluster()
    cl = LibClient(c)
    try:
        cl.put(REP_POOL, "tracked", b"x" * 100)
        _, _, primary = c.primary_of(REP_POOL, "tracked")
        hist = c.osds[primary].op_tracker.dump_historic()
        assert any("tracked" in o["description"] for o in hist["ops"])
        ops = [o for o in hist["ops"] if "tracked" in o["description"]]
        evts = [e["event"] for e in ops[0]["events"]]
        assert "queued_for_pg" in evts and "reached_pg" in evts
        assert any(e.startswith("commit_sent") for e in evts)
    finally:
        cl.shutdown()
        c.shutdown()
