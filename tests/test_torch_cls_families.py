"""The ``client.rados`` forms of ``tests/test_cls_families.py``
(``:35,66,83,199,239``): the journal, numops, timeindex and otp object
classes, and a buggy method failing its op with ``EIO``, called by
``IoCtx.call`` through the port's client on the port's cluster.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), the client ``torch_daemon_harness.LibClient``.  The
same cases run as ``MOSDOp``s through both packages' PGs, and the EC
plugin load-failure cases over the port's registry, in
``tests/test_torch_cls.py``.
"""

import json

import pytest

import torch_daemon_harness as H

REP_POOL = H.REP_POOL


@pytest.fixture(scope="module")
def cluster():
    c = H.DaemonCluster("ceph_tpu_torch", device="cpu")
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def io(cluster):
    cl = H.LibClient(cluster)
    yield cl.rc.ioctx(REP_POOL)
    cl.shutdown()


# -- cls_journal ------------------------------------------------------------

def test_cls_journal_clients(io):
    oid = "jmeta"
    io.call(oid, "journal", "client_register",
            json.dumps({"id": "mirrorA"}).encode())
    io.call(oid, "journal", "client_register",
            json.dumps({"id": "mirrorB", "commit": 5}).encode())
    # duplicate registration is EEXIST
    from ceph_tpu_torch.client.rados import RadosError

    with pytest.raises(RadosError):
        io.call(oid, "journal", "client_register",
                json.dumps({"id": "mirrorA"}).encode())
    # commit positions are monotonic
    io.call(oid, "journal", "client_commit",
            json.dumps({"id": "mirrorA", "commit": 9}).encode())
    io.call(oid, "journal", "client_commit",
            json.dumps({"id": "mirrorA", "commit": 3}).encode())  # no-op
    got = json.loads(io.call(oid, "journal", "get_client",
                             b"mirrorA").decode())
    assert got["commit"] == 9
    clients = json.loads(io.call(oid, "journal", "client_list",
                                 b"").decode())
    assert [c["id"] for c in clients] == ["mirrorA", "mirrorB"]
    io.call(oid, "journal", "client_unregister", b"mirrorB")
    clients = json.loads(io.call(oid, "journal", "client_list",
                                 b"").decode())
    assert [c["id"] for c in clients] == ["mirrorA"]


# -- cls_numops -------------------------------------------------------------

def test_cls_numops(io):
    oid = "nums"
    assert io.call(oid, "numops", "add", b"x 5") == b"5"
    assert io.call(oid, "numops", "add", b"x 2.5") == b"7.5"
    assert io.call(oid, "numops", "mul", b"x 2") == b"15"
    from ceph_tpu_torch.client.rados import RadosError

    with pytest.raises(RadosError):
        io.call(oid, "numops", "add", b"garbage")
    # non-numeric stored value is EINVAL, like the reference
    io.omap_set(oid, {"bad": b"not-a-number"})
    with pytest.raises(RadosError):
        io.call(oid, "numops", "add", b"bad 1")


# -- cls_timeindex ----------------------------------------------------------

def test_cls_timeindex(io):
    oid = "tindex"
    for i, ts in enumerate((10.0, 20.0, 30.0, 40.0)):
        io.call(oid, "timeindex", "add",
                json.dumps({"ts": ts, "key": f"e{i}",
                            "value": f"v{i}"}).encode())
    got = json.loads(io.call(
        oid, "timeindex", "list",
        json.dumps({"from": 15, "to": 35}).encode()).decode())
    assert [e["key"] for e in got] == ["e1", "e2"]
    trimmed = int(io.call(oid, "timeindex", "trim",
                          json.dumps({"to": 25}).encode()))
    assert trimmed == 2
    got = json.loads(io.call(oid, "timeindex", "list", b"").decode())
    assert [e["key"] for e in got] == ["e2", "e3"]


# -- cls_otp ----------------------------------------------------------------

def _totp_ref(seed_hex: str, t: float, step: int = 30,
              digits: int = 6) -> str:
    """Independent RFC-6238 computation for the test side."""
    import hashlib
    import hmac
    import struct

    counter = int(t // step)
    mac = hmac.new(bytes.fromhex(seed_hex), struct.pack(">Q", counter),
                   hashlib.sha1).digest()
    off = mac[-1] & 0xF
    code = (struct.unpack(">I", mac[off:off + 4])[0]
            & 0x7FFFFFFF) % (10 ** digits)
    return f"{code:0{digits}d}"


def test_cls_otp(io):
    oid = "otp_store"
    seed = "3132333435363738393031323334353637383930"  # RFC 6238 vector
    io.call(oid, "otp", "set",
            json.dumps({"id": "tok1", "seed": seed}).encode())
    assert json.loads(io.call(oid, "otp", "list").decode()) == ["tok1"]

    now = 1_700_000_000.0
    good = _totp_ref(seed, now)
    assert io.call(oid, "otp", "check", json.dumps(
        {"id": "tok1", "code": good, "now": now}).encode()) == b"ok"
    # replay: the same code is consumed
    assert io.call(oid, "otp", "check", json.dumps(
        {"id": "tok1", "code": good, "now": now}).encode()) == b"replay"
    # wrong code fails
    bad = f"{(int(good) + 1) % 1_000_000:06d}"
    assert io.call(oid, "otp", "check", json.dumps(
        {"id": "tok1", "code": bad, "now": now}).encode()) == b"fail"
    res = json.loads(io.call(oid, "otp", "get_result", b"tok1").decode())
    assert res["last_result"] == "fail"
    # next step's code works (monotonic counter)
    nxt = _totp_ref(seed, now + 30)
    assert io.call(oid, "otp", "check", json.dumps(
        {"id": "tok1", "code": nxt, "now": now + 30}).encode()) == b"ok"
    # window: a code one step old is accepted once
    now2 = now + 300
    prev = _totp_ref(seed, now2 - 30)
    assert io.call(oid, "otp", "check", json.dumps(
        {"id": "tok1", "code": prev, "now": now2}).encode()) == b"ok"
    io.call(oid, "otp", "remove", b"tok1")
    assert json.loads(io.call(oid, "otp", "list").decode()) == []
    from ceph_tpu_torch.client.rados import RadosError
    with pytest.raises(RadosError):
        io.call(oid, "otp", "check", json.dumps(
            {"id": "tok1", "code": "000000"}).encode())
    with pytest.raises(RadosError):
        io.call(oid, "otp", "set", json.dumps(
            {"id": "t2", "seed": "zz"}).encode())  # non-hex seed


def test_buggy_cls_method_fails_op_instead_of_hanging(io):
    """A cls method that raises a non-ClsError must come back as -EIO
    (the reference's unexpected-failure contract) — before this guard
    the exception escaped the PG worker and the op TIMED OUT."""
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.osd.cls import CLS_RD, CLS_WR, ClassHandler

    h = ClassHandler.instance()
    if h.get("testbug.boom") is None:
        def boom(ctx, indata):
            raise TypeError("not a ClsError")
        h.register("testbug", "boom", CLS_RD | CLS_WR, boom)
    with pytest.raises(RadosError) as ei:
        io.call("bugobj", "testbug", "boom", b"")
    assert ei.value.rc == -5  # EIO, and promptly
