"""The port's PaxosService family (``ceph_tpu_torch/mon/services.py``):
Config/Log/Health/Auth monitors, on the CPU.

Mirrors ``tests/test_mon_services.py`` case for case (all six), with the
port's ``Monitor`` on ``device="cpu"``; the reference's notes follow.

Reference: src/mon/PaxosService.h — service state machines that commit
through the monitor's Paxos.  Single-mon clusters commit synchronously
(propose -> quorum of 1 -> _commit), so command effects are immediate;
cross-mon replication is pinned by feeding the committed value to a
second mon's `_learn` (the path a peon's COMMIT handler takes).
"""

import pytest

from ceph_tpu_torch.auth.keyring import Keyring
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.mon.monitor import MonMap, Monitor, STATE_LEADER
from ceph_tpu_torch.mon.services import SVC_TAG, encode_payload
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.store.kv import MemDB

_made = []


def make_solo_mon(kv=None, keyring=None):
    ctx = Context("test.svc", {})
    monmap = MonMap([("127.0.0.1", 11000)])
    cm, _root = cmap.build_flat_cluster(3, hosts=3)
    mon = Monitor(ctx, 0, monmap, kv=kv or MemDB(),
                  initial_map=OSDMap(cm, max_osd=3, device="cpu"),
                  keyring=keyring, device="cpu")
    mon.kv.open()
    mon._load()
    mon._send_mon = lambda r, msg: None
    mon._push_maps = lambda: None  # no sockets in these tests
    mon.state = STATE_LEADER
    mon.leader = 0
    _made.append(mon)
    return mon


@pytest.fixture(autouse=True)
def _quiesce():
    yield
    for mon in _made:
        mon._stop.set()
    _made.clear()


def test_config_set_get_precedence_and_rm():
    mon = make_solo_mon()
    for who, key, val in (("global", "debug", "1"),
                          ("osd", "debug", "5"),
                          ("osd.1", "debug", "9"),
                          ("global", "other", "x")):
        code, _ = mon._do_command({"prefix": "config set", "who": who,
                                   "name": key, "value": val})
        assert code == 0
    _, out = mon._do_command({"prefix": "config get", "who": "osd.1"})
    assert out["config"]["debug"] == "9"       # most-specific wins
    _, out = mon._do_command({"prefix": "config get", "who": "osd.2"})
    assert out["config"]["debug"] == "5"       # type level
    _, out = mon._do_command({"prefix": "config get", "who": "client.x"})
    assert out["config"]["debug"] == "1"       # global
    assert out["config"]["other"] == "x"
    code, _ = mon._do_command({"prefix": "config rm", "who": "osd.1",
                               "name": "debug"})
    _, out = mon._do_command({"prefix": "config get", "who": "osd.1"})
    assert out["config"]["debug"] == "5"
    _, out = mon._do_command({"prefix": "config dump"})
    assert "global" in out["config"]


def test_config_survives_restart():
    kv = MemDB()
    mon = make_solo_mon(kv=kv)
    mon._do_command({"prefix": "config set", "who": "global",
                     "name": "k", "value": "v"})
    mon2 = make_solo_mon(kv=kv)
    _, out = mon2._do_command({"prefix": "config get", "who": "mds.a"})
    assert out["config"]["k"] == "v"


def test_cluster_log_append_tail_retention():
    mon = make_solo_mon()
    for i in range(30):
        code, _ = mon._do_command({"prefix": "log", "who": "osd.0",
                                   "logtext": f"event {i}"})
        assert code == 0
    _, out = mon._do_command({"prefix": "log last", "num": 5})
    assert [e["msg"] for e in out["lines"]] == [
        f"event {i}" for i in range(25, 30)]
    logm = mon.services["logm"]
    logm.KEEP = 10
    logm.log("osd.1", "overflow")
    assert len(logm.entries) == 10  # retention bound


def test_health_derives_from_map_and_mutes():
    mon = make_solo_mon()
    _, out = mon._do_command({"prefix": "health"})
    assert out["status"] == "HEALTH_OK"
    mon.osdmap.set_osd_down(1)
    _, out = mon._do_command({"prefix": "health"})
    assert out["status"] == "HEALTH_WARN"
    assert "OSD_DOWN" in out["checks"]
    code, _ = mon._do_command({"prefix": "health mute",
                               "check": "OSD_DOWN"})
    assert code == 0
    _, out = mon._do_command({"prefix": "health"})
    assert out["status"] == "HEALTH_OK"      # muted check doesn't count
    assert "OSD_DOWN" in out["checks"]       # but is still reported
    mon._do_command({"prefix": "health unmute", "check": "OSD_DOWN"})
    _, out = mon._do_command({"prefix": "health"})
    assert out["status"] == "HEALTH_WARN"


def test_auth_get_or_create_and_replication():
    kr = Keyring()
    kr.add("mon.")
    mon = make_solo_mon(keyring=kr)
    code, out = mon._do_command({"prefix": "auth get-or-create",
                                 "entity": "client.app"})
    assert code == 0
    key = out["key"]
    # idempotent: second call returns the same key
    _, out2 = mon._do_command({"prefix": "auth get-or-create",
                               "entity": "client.app"})
    assert out2["key"] == key
    _, out = mon._do_command({"prefix": "auth ls"})
    assert "client.app" in out["entities"]

    # a peon applies the same committed value via _learn
    kr2 = Keyring()
    kr2.add("mon.")
    peon = make_solo_mon(keyring=kr2)
    value = encode_payload("auth", {"op": "add", "entity": "client.app",
                                    "secret": key})
    peon._learn(peon.last_committed + 1, value)
    assert peon.auth_server.keyring.get("client.app").hex() == key

    mon._do_command({"prefix": "auth rm", "entity": "client.app"})
    code, _ = mon._do_command({"prefix": "auth get",
                               "entity": "client.app"})
    assert code == -2


def test_service_values_skipped_by_map_path():
    """A SVC_TAG value must never be misread as a map commit."""
    mon = make_solo_mon()
    epoch_before = mon.osdmap.epoch
    mon._learn(mon.last_committed + 1,
               encode_payload("logm", {"who": "x", "msg": "m", "level": "info",
                                       "stamp": 0.0}))
    assert mon.osdmap.epoch == epoch_before
    assert mon.services["logm"].entries[-1]["msg"] == "m"
    # and reload skips it rather than trying to decode a map from it
    mon2 = make_solo_mon(kv=mon.kv)
    assert mon2.last_committed == mon.last_committed
