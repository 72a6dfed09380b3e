"""The port's monitor held to the reference's (``ceph_tpu/mon/``), on
the CPU.

- A quorum of mons from both packages: two reference ``Monitor``s and
  one port ``Monitor`` (``device="cpu"``), and the reverse, each with
  the rank-0 mon (the leader by deference) from the minority package.
  Through the leader they commit an EC profile, a replicated and an EC
  pool create, an ``osd out``/``osd in`` pair and a ``config set``;
  every member then holds the same Paxos values (the bytes of each
  version in its KV), the same encoded ``OSDMap`` and the same config
  database at the same ``last_committed``.
- A mon store: a solo ``Monitor`` of one package on ``LSMStore``
  commits the same sequence and shuts down; a ``Monitor`` of the other
  package mounts the directory and starts with the same committed
  state, commits one more value, and the first package mounts it back.
- F11: a mon past a gap that ends in a service value catches its map up
  (the port; the reference keeps the stale map).
- F15: a leader whose map value was dropped before it committed builds
  the next one on its committed map, so an OSD's boot retry lands (the
  port; the reference's retries carry nothing).
- ``PGMapService``: both packages' solo mons (no sockets) fed one
  ``MPGStats`` sequence, built by the port and decoded from its bytes by
  the reference, with each PGMap's clock pinned, answer ``pg dump``,
  ``osd df``, ``df``, ``status``, ``health`` and ``health detail`` with
  the same JSON.

Every wait polls with a deadline.
"""

import json
import socket
import time

import pytest

import ceph_tpu.core.context as ref_context
import ceph_tpu.crush.map as ref_cmap
import ceph_tpu.mon.monitor as ref_monitor
import ceph_tpu.osd.map_codec as ref_codec
import ceph_tpu.osd.osdmap as ref_osdmap
import ceph_tpu.store.kv as ref_kv
import ceph_tpu.store.lsm as ref_lsm
from ceph_tpu.msg.message import Message as RefMessage
from ceph_tpu_torch.core import context as port_context
from ceph_tpu_torch.crush import map as port_cmap
from ceph_tpu_torch.mon import messages as mm
from ceph_tpu_torch.mon import monitor as port_monitor
from ceph_tpu_torch.mon.services import SVC_TAG
from ceph_tpu_torch.osd import map_codec as port_codec
from ceph_tpu_torch.osd import osdmap as port_osdmap
from ceph_tpu_torch.osd.types import EVersion, PGStat
from ceph_tpu_torch.store import kv as port_kv
from ceph_tpu_torch.store import lsm as port_lsm

N_OSDS = 4
CONF = {"mon_tick_interval": 0.5}


class Pkg:
    """One package's monitor, map and store modules."""

    def __init__(self, name, context, cmap, monitor, codec, osdmap, kv,
                 lsm, **kw) -> None:
        self.name, self.context, self.cmap = name, context, cmap
        self.monitor, self.codec, self.osdmap = monitor, codec, osdmap
        self.kv, self.lsm, self.kw = kv, lsm, kw

    def seed(self):
        cm, _root = self.cmap.build_flat_cluster(N_OSDS, hosts=N_OSDS)
        m = self.osdmap.OSDMap(cm, max_osd=N_OSDS, **self.kw)
        m.osd_state_up[:] = False
        return m

    def mon(self, rank, addrs, kv=None, initial_map="seed", port=0):
        return self.monitor.Monitor(
            self.context.Context(f"{self.name}.mon{rank}", dict(CONF)),
            rank, self.monitor.MonMap(addrs), kv=kv,
            initial_map=self.seed() if initial_map == "seed" else None,
            bind_port=port, **self.kw)

    def encoded_map(self, mon) -> bytes:
        return self.codec.encode_osdmap(mon.osdmap)


REF = Pkg("ceph_tpu", ref_context, ref_cmap, ref_monitor, ref_codec,
          ref_osdmap, ref_kv, ref_lsm)
PORT = Pkg("ceph_tpu_torch", port_context, port_cmap, port_monitor,
           port_codec, port_osdmap, port_kv, port_lsm, device="cpu")


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_for(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timeout waiting for {what}")


# the commands both tests commit through a leader, each answered 0
COMMANDS = (
    {"prefix": "osd erasure-code-profile set", "name": "k2m1",
     "profile": "plugin=isa k=2 m=1 technique=reed_sol_van"},
    {"prefix": "osd pool create", "pool": "rbd", "pg_num": 8},
    {"prefix": "osd pool create", "pool": "ecpool", "pg_num": 8,
     "pool_type": "erasure", "erasure_code_profile": "k2m1"},
    {"prefix": "osd out", "id": 1},
    {"prefix": "osd in", "id": 1},
    {"prefix": "config set", "who": "global", "name": "xk", "value": "xv"},
)


def run_commands(mon) -> None:
    for cmd in COMMANDS:
        code, out = mon._do_command(cmd)
        assert code == 0, (cmd, out)


def state(pkg, mon) -> dict:
    """What a mon has committed, comparable across the packages."""
    with mon.lock:
        lc = mon.last_committed
        return {
            "last_committed": lc,
            "values": [mon.kv.get("paxos_values", str(v))
                       for v in range(1, lc + 1)],
            "osdmap": pkg.encoded_map(mon),
            "config": json.dumps(mon.services["config"].db, sort_keys=True),
        }


@pytest.mark.parametrize("layout", [
    (PORT, REF, REF),   # a port leader, reference peons
    (REF, PORT, PORT),  # a reference leader, port peons
], ids=["port-leads", "ref-leads"])
def test_a_mixed_quorum_commits_the_same_values(layout):
    ports = free_ports(len(layout))
    addrs = [("127.0.0.1", p) for p in ports]
    mons = []
    try:
        for rank, pkg in enumerate(layout):
            mon = pkg.mon(rank, addrs, port=ports[rank])
            mon.start()
            mons.append(mon)
        # rank 0 leads; a peon may keep the "electing" label when a
        # late PROPOSE of rank 1 lands after rank 0's VICTORY (both
        # packages' _handle_election; ROADMAP queue 3, F10), and it
        # still accepts and learns every value
        wait_for(lambda: [m.state == "leader" for m in mons]
                 == [True, False, False] and mons[0]._collect_complete,
                 what="rank 0 leads")
        leader = mons[0]
        assert leader.__class__.__module__.startswith(layout[0].name)
        run_commands(leader)

        def done():
            st = [state(pkg, m) for pkg, m in zip(layout, mons)]
            return (st[0]["last_committed"] >= len(COMMANDS) - 1
                    and "xk" in st[0]["config"]
                    and all(s == st[0] for s in st[1:]))

        wait_for(done, what="every mon at the leader's committed state")
        # one value a map epoch (pools, out, in) and one the config set;
        # the leader's health tick may log through paxos too
        values = state(layout[0], leader)["values"]
        assert sum(v[0] == SVC_TAG for v in values) >= 1
        assert sum(v[0] != SVC_TAG for v in values) == len(COMMANDS) - 2
        for pkg, m in zip(layout, mons):
            names = {p.name for p in m.osdmap.pools.values()}
            assert names == {"rbd", "ecpool"}, pkg.name
            assert m.osdmap.epoch == leader.osdmap.epoch
            assert m.services["config"].db == {"global": {"xk": "xv"}}
        # the profile is the leader's own (not paxos state)
        assert "k2m1" in leader.ec_profiles
    finally:
        for m in mons:
            m.shutdown()


def _solo(pkg, path, initial_map="seed"):
    port = free_ports(1)[0]
    mon = pkg.mon(0, [("127.0.0.1", port)], kv=pkg.lsm.LSMStore(path),
                  initial_map=initial_map, port=port)
    mon.start()
    wait_for(lambda: mon.state == "leader" and mon._collect_complete,
             what=f"the solo {pkg.name} mon leads")
    return mon


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port-writes", "ref-writes"])
def test_a_mon_store_remounts_under_the_other_package(tmp_path, writer,
                                                      reader):
    path = str(tmp_path / "mon0")
    mon = _solo(writer, path)
    try:
        run_commands(mon)
        wait_for(lambda: mon.last_committed == len(COMMANDS) - 1
                 and not mon._proposing, what="the writer committed")
        want = state(writer, mon)
        profiles = dict(mon.ec_profiles)
    finally:
        mon.shutdown()

    mon = _solo(reader, path, initial_map=None)
    try:
        got = state(reader, mon)
        assert got == want
        assert mon.ec_profiles == profiles
        code, out = mon._do_command({"prefix": "config set", "who": "osd",
                                     "name": "yk", "value": "yv"})
        assert code == 0, out
        wait_for(lambda: mon.last_committed == len(COMMANDS)
                 and not mon._proposing, what="the reader committed")
        want = state(reader, mon)
    finally:
        mon.shutdown()

    mon = _solo(writer, path, initial_map=None)
    try:
        assert state(writer, mon) == want
        assert mon.services["config"].db["osd"] == {"yk": "yv"}
    finally:
        mon.shutdown()


def _stats_sequence():
    """(stamp, port MPGStats) reports from four OSDs: a primary and a
    replica row a PG, degraded and recovering rows, scrub errors, a slow
    op count, a heartbeat-miss counter that grows, a near-full and a full
    store, and osd.3's report left stale."""
    seq = []
    for t, osd, gen in ((100.0, 0, 0), (100.5, 1, 0), (101.0, 2, 0),
                        (40.0, 3, 0), (110.0, 0, 1), (110.5, 1, 1),
                        (111.0, 2, 1)):
        stats = []
        for ps in range(6):
            pgid = (1 + ps % 2, ps)
            primary = ps % 3 == osd % 3
            state = "active"
            if ps == 2:
                state = "active+degraded" if gen else "peering"
            elif ps == 4 and gen:
                state = "active+recovering"
            stats.append(PGStat(
                pgid=pgid, state=state, primary=primary,
                num_objects=10 * ps + osd, num_bytes=4096 * (ps + 1),
                log_size=ps + gen, degraded=3 if ps == 2 and gen else 0,
                misplaced=ps % 2, unfound=1 if ps == 5 and gen else 0,
                last_update=EVersion(3 + gen, 7 * ps + gen),
                cl_wr_ops=5 * gen + ps, cl_wr_bytes=4096 * gen * ps,
                cl_rd_ops=ps, cl_rd_bytes=512 * ps,
                rec_ops=2 * gen, rec_bytes=8192 * gen,
                last_scrub=50.0 + ps, last_deep_scrub=0.0 if ps == 1
                else 20.0 + ps, scrub_errors=2 if ps == 3 else 0))
        used = {0: 10, 1: 90, 2: 96, 3: 5}[osd] << 20
        seq.append((t, mm.MPGStats(
            osd=osd, epoch=4 + gen, used_bytes=used, total_bytes=100 << 20,
            stats=stats, slow_ops=2 if osd == 1 else 0,
            heartbeat_misses=3 * gen if osd == 2 else 0)))
    return seq


def _fed_mon(pkg, clock):
    mon = pkg.mon(0, [("127.0.0.1", 1)])
    mon.kv.open()
    mon._load()
    mon._send_mon = lambda r, msg: None
    mon._push_maps = lambda: None  # no sockets here
    mon.state = pkg.monitor.STATE_LEADER
    mon.leader = 0
    mon.pgmap._now = lambda: clock[0]
    for i in range(N_OSDS):
        mon.osdmap.set_osd_up(i)
    mon.osdmap.set_osd_down(3)
    mon.osdmap.set_osd_out(3)
    return mon


def test_pgmap_answers_equal_the_reference():
    clock = [0.0]
    mons = {pkg.name: _fed_mon(pkg, clock) for pkg in (PORT, REF)}
    conf = {"mon_pg_stats_stale_s": 30.0, "mon_stats_rate_window": 20.0,
            "mon_warn_not_deep_scrubbed_s": 60.0,
            "mon_pg_stuck_threshold": 5.0}
    for mon in mons.values():
        for k, v in conf.items():
            mon.ctx.conf.set_val(k, v)
    answers = {name: [] for name in mons}
    for stamp, msg in _stats_sequence():
        clock[0] = stamp
        wire = msg.to_bytes()
        ref_msg = RefMessage.from_bytes(wire)
        assert ref_msg.to_bytes() == wire
        assert mons[PORT.name].ms_dispatch(None, msg)
        assert mons[REF.name].ms_dispatch(None, ref_msg)
        clock[0] = stamp + 0.25
        for name, mon in mons.items():
            out = {}
            for prefix in ("pg dump", "osd df", "df", "status", "health",
                           "health detail"):
                code, got = mon._do_command({"prefix": prefix})
                assert code == 0, (name, prefix, got)
                out[prefix] = got
            answers[name].append(json.dumps(out, sort_keys=True))
    assert answers[PORT.name] == answers[REF.name]
    last = json.loads(answers[PORT.name][-1])
    # the sequence reached every check it was built for
    assert set(last["health"]["checks"]) >= {
        "OSD_DOWN", "OSD_OUT", "PG_DEGRADED", "OBJECT_DEGRADED",
        "OBJECT_UNFOUND", "PG_DAMAGED", "PG_NOT_DEEP_SCRUBBED", "SLOW_OPS",
        "OSD_SLOW_HEARTBEAT", "OSD_FULL", "OSD_NEARFULL"}
    assert last["pg dump"]["num_pg_stats"] == 6
    assert last["status"]["io"]["client_write_ops_per_s"] > 0
    for mon in mons.values():
        mon._stop.set()


class _Conn:
    def __init__(self) -> None:
        self.sent = []

    def send(self, msg) -> None:
        self.sent.append(msg)


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_a_gap_that_ends_in_a_service_value_catches_the_map_up(pkg):
    """F11 (ROADMAP queue 3): a mon that learns a version past a gap
    (a restarted leader's collect hands it only the peers' latest value)
    whose last value is a service payload.  The port's mon asks the
    leader for the full map too, adopts it, and boots from it again
    (the skipped versions' values are not in its store); a catch-up
    answered with no newer map anchors its own.  The reference's asks
    only for the services' snapshot, and its map stays at the epoch it
    had."""
    ahead = _fed_mon(pkg, [0.0])   # a solo leader: commits at once
    for cmd in COMMANDS[:3] + COMMANDS[-1:]:
        code, out = ahead._do_command(cmd)
        assert code == 0, (cmd, out)
    top = ahead.last_committed
    value = ahead.kv.get("paxos_values", str(top))
    assert value[0] == SVC_TAG  # the config set: a service value
    behind = pkg.mon(0, [("127.0.0.1", 1), ("127.0.0.1", 2)])
    behind.kv.open()
    behind._load()
    behind.leader, behind.state = 1, pkg.monitor.STATE_PEON
    sent = []
    behind._send_mon = lambda r, msg: sent.append((r, msg))
    behind._push_maps = lambda: None
    epoch0 = behind.osdmap.epoch
    with behind.lock:
        behind._learn(top, value)
    ops = [(r, msg.op) for r, msg in sent]
    paxos = pkg.monitor.mm.MMonPaxos
    assert (1, paxos.SYNC_REQ) in ops
    if pkg is REF:
        assert (1, paxos.CATCHUP_REQ) not in ops
        assert behind.osdmap.epoch == epoch0 < ahead.osdmap.epoch
    else:
        req = next(msg for r, msg in sent if msg.op == paxos.CATCHUP_REQ)
        conn = _Conn()
        ahead._handle_paxos(conn, req)
        behind._handle_paxos(conn, conn.sent[0])
        assert behind.osdmap.epoch == ahead.osdmap.epoch > epoch0
        assert PORT.encoded_map(behind) == PORT.encoded_map(ahead)
        assert behind._catchup_want == 0
        # the adopted map is the boot anchor: a restart over the store
        # loads it, though the skipped versions' values are not there
        again = pkg.mon(0, [("127.0.0.1", 1), ("127.0.0.1", 2)],
                        kv=behind.kv, initial_map=None)
        again._load()
        assert PORT.encoded_map(again) == PORT.encoded_map(ahead)
        assert getattr(again, "_catchup_want", 0) == 0
        # a catch-up answered by a peer at the wanted version with no
        # newer map anchors the mon's own map there
        again._catchup_want = top
        rep = pkg.monitor.mm.MMonPaxos(paxos.CATCHUP, 0, version=top,
                                       value=conn.sent[0].value)
        again._handle_paxos(conn, rep)
        assert again._catchup_want == 0
        assert again.kv.get("mon", "latest_full_v") == str(top).encode()
    assert behind.last_committed == top
    # the value learned is applied (the skipped ones: the snapshot's job)
    assert behind.services["config"].db == {"global": {"xk": "xv"}}
    for mon in (ahead, behind):
        mon._stop.set()



@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_a_dropped_map_value_is_built_again_on_the_committed_map(pkg):
    """F15 (ROADMAP queue 3): a leader builds each map value on its
    pending map.  When a value is dropped before it commits (here a
    propose refused while the mon is not leading; also the queue cleared
    when it steps down), the pending map stays ahead with that change,
    and every later delta against it leaves the change out: an OSD
    that booted then retries its boot every second and never shows up
    (seen in the ``vstart`` phase on the card, OSDs booting during the
    first election).  The port's leader starts over from the committed
    map once nothing is in flight; the reference's does not."""
    mon = _fed_mon(pkg, [0.0])   # a solo leader: commits at once
    assert not mon.osdmap.is_up(3)

    def boot(nm) -> None:
        nm.set_osd_up(3)

    with mon.lock:
        mon.state = pkg.monitor.STATE_ELECTING   # the propose is refused
        mon._mutate_map(boot)
        mon.state = pkg.monitor.STATE_LEADER
    epoch0 = mon.osdmap.epoch
    assert not mon.osdmap.is_up(3) and mon._pending_map.is_up(3)
    with mon.lock:
        mon._mutate_map(boot)                     # the boot's retry
    if pkg is PORT:
        assert mon.osdmap.is_up(3) and mon.osdmap.epoch > epoch0
    else:
        assert not mon.osdmap.is_up(3)
    mon._stop.set()
