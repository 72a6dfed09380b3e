"""``tests/test_striper_cls.py`` mirrored on the port's cluster: the
port's ``RadosStriper`` (``ceph_tpu_torch/client/striper.py``) and object
classes called by ``IoCtx.call`` through the port's client.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), the client ``torch_daemon_harness.LibClient``.  The
cls cases also run as ``MOSDOp``s through both packages' PGs in
``tests/test_torch_cls.py``.
"""

import numpy as np
import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.client.striper import RadosStriper
from ceph_tpu_torch.osd.cls import CLS_RD, ClassHandler

REP_POOL = H.REP_POOL


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


@pytest.fixture()
def striper(client):
    return RadosStriper(client.rc.ioctx(REP_POOL), stripe_unit=1024,
                        stripe_count=3, object_size=4096)


def test_striped_write_read_roundtrip(striper, client):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=50_000, dtype=np.uint8).tobytes()
    striper.write("sfile", data)
    assert striper.stat("sfile") == len(data)
    assert striper.read("sfile") == data
    # ranged reads across stripe boundaries
    assert striper.read("sfile", length=5000, off=1000) == data[1000:6000]
    assert striper.read("sfile", length=10, off=49_995) == data[49_995:]
    # the data actually spans multiple objects
    io = client.rc.ioctx(REP_POOL)
    names = [f"sfile.{i:016x}" for i in range(4)]
    present = sum(1 for n in names if _exists(io, n))
    assert present >= 3, "striper did not spread objects"


def _exists(io, name):
    try:
        io.stat(name)
        return True
    except RadosError:
        return False


def test_striped_partial_overwrite(striper):
    base = b"a" * 20_000
    striper.write("sfile2", base)
    striper.write("sfile2", b"B" * 3000, off=5000)
    got = striper.read("sfile2")
    assert got == base[:5000] + b"B" * 3000 + base[8000:]


def test_striped_truncate_and_remove(striper, client):
    striper.write("sfile3", b"x" * 30_000)
    striper.truncate("sfile3", 10_000)
    assert striper.stat("sfile3") == 10_000
    assert striper.read("sfile3") == b"x" * 10_000
    striper.remove("sfile3")
    with pytest.raises(RadosError):
        striper.size("sfile3")


def test_layout_math_inverse():
    s = RadosStriper.__new__(RadosStriper)
    s.su, s.sc, s.os = 1024, 3, 4096
    s.su_per_obj = 4
    for off in (0, 1023, 1024, 5000, 12288, 50_000):
        covered = []
        for objno, o, units in s._extents(off, 3000):
            assert o == units[0][0]
            at = o
            for uo, lpos, n in units:
                assert uo == at  # contiguous in the object
                at += n
                assert s._logical_pos(objno, uo) == lpos
                covered.append((lpos, n))
        covered.sort()
        pos = off
        for lpos, n in covered:  # logical range covered exactly once
            assert lpos == pos
            pos += n
        assert pos == off + 3000


# -- cls ---------------------------------------------------------------------

def test_cls_lock_exclusive(client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("locked", b"payload")
    io.call("locked", "lock", "lock",
            b'{"name": "l1", "owner": "client.a"}')
    # second owner is refused
    with pytest.raises(RadosError) as ei:
        io.call("locked", "lock", "lock",
                b'{"name": "l1", "owner": "client.b"}')
    assert ei.value.rc == -16  # EBUSY
    info = io.call("locked", "lock", "get_info", b'{"name": "l1"}')
    assert b"client.a" in info
    io.call("locked", "lock", "unlock",
            b'{"name": "l1", "owner": "client.a"}')
    # now free for the other owner
    io.call("locked", "lock", "lock",
            b'{"name": "l1", "owner": "client.b"}')


def test_cls_refcount_delete_on_zero(client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("counted", b"shared")
    io.call("counted", "refcount", "get", b"user1")
    io.call("counted", "refcount", "get", b"user2")
    assert b"user1" in io.call("counted", "refcount", "read")
    io.call("counted", "refcount", "put", b"user1")
    assert io.read("counted") == b"shared"  # still referenced
    io.call("counted", "refcount", "put", b"user2")
    with pytest.raises(RadosError):  # last ref dropped -> deleted
        io.read("counted")


def test_cls_version_check(client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("versioned", b"v")
    io.call("versioned", "version", "set", b"7")
    assert io.call("versioned", "version", "get") == b"7"
    io.call("versioned", "version", "check", b"7")
    with pytest.raises(RadosError) as ei:
        io.call("versioned", "version", "check", b"8")
    assert ei.value.rc == -22


def test_cls_runtime_registration(client):
    """Third-party classes register at runtime (the reference's
    dlopen-a-new-.so extension point)."""
    h = ClassHandler.instance()

    def echo_upper(ctx, indata):
        return indata.upper()

    h.register("demo", "upper", CLS_RD, echo_upper)
    try:
        io = client.rc.ioctx(REP_POOL)
        io.write_full("demo1", b"x")
        assert io.call("demo1", "demo", "upper", b"hello") == b"HELLO"
        # unknown method surfaces EINVAL
        with pytest.raises(RadosError):
            io.call("demo1", "demo", "nope")
    finally:
        h._methods.pop("demo.upper", None)
