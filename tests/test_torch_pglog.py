"""The port's PG log (``ceph_tpu_torch/osd/pglog.py``) held to
``ceph_tpu.osd.pglog``: a seeded sequence of appends, trims and rewinds
runs on both packages' ``PGLog``s; after every step the omap rows (keys
and value bytes) and the logs read back by ``from_omap`` are equal, each
package reads the other's rows, and ``rewind_to`` passes the port's
``pglog.rewind`` failpoint exactly when it drops entries."""

import numpy as np
import pytest

from ceph_tpu.osd import pglog as ref_pglog
from ceph_tpu.osd import types as ref_types
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.osd import pglog, types


@pytest.fixture(autouse=True)
def _disarm():
    fp.disarm_all()
    yield
    fp.disarm_all()


def _fields(en) -> tuple:
    return (en.op, en.oid, (en.version.epoch, en.version.version),
            (en.prior_version.epoch, en.prior_version.version), en.mtime,
            bytes(en.payload), en.reqid)


def _entry(mod, rng, epoch: int, version: int, prior: int):
    ops = (mod.LOG_MODIFY, mod.LOG_DELETE, mod.LOG_ERROR)
    return mod.LogEntry(
        op=ops[int(rng.integers(0, 3))], oid=f"obj-{int(rng.integers(0, 9))}",
        version=mod.EVersion(epoch, version),
        prior_version=mod.EVersion(epoch, prior),
        mtime=float(rng.integers(0, 1 << 30)) / 7.0,
        payload=rng.integers(0, 256, int(rng.integers(0, 40)),
                             dtype=np.uint8).tobytes(),
        reqid=f"client.{int(rng.integers(1, 5))}:{version}")


def _omap(log, entries) -> dict:
    return log.omap_additions(entries)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_log_equals_the_reference(seed):
    rng_p = np.random.default_rng(seed)
    rng_r = np.random.default_rng(seed)
    port, ref = pglog.PGLog(), ref_pglog.PGLog()
    omap_p, omap_r = {}, {}
    epoch, version, rewinds = 3, 0, 0
    for step in range(120):
        action = ("append", "append", "append", "trim", "rewind")[
            int(rng_p.integers(0, 5))]
        rng_r.integers(0, 5)
        if action == "append":
            if int(rng_p.integers(0, 10)) == 0:
                rng_r.integers(0, 10)
                epoch += 1
            else:
                rng_r.integers(0, 10)
            version += 1
            ep = _entry(types, rng_p, epoch, version, version - 1)
            er = _entry(ref_types, rng_r, epoch, version, version - 1)
            port.append(ep)
            ref.append(er)
            omap_p.update(_omap(port, [ep]))
            omap_r.update(_omap(ref, [er]))
        elif action == "trim":
            keep = int(rng_p.integers(1, 30))
            rng_r.integers(1, 30)
            tp, tr = port.trim_to(keep), ref.trim_to(keep)
            assert [_fields(e) for e in tp] == [_fields(e) for e in tr]
            for key in port.omap_removals(tp):
                del omap_p[key]
            for key in ref.omap_removals(tr):
                del omap_r[key]
        else:
            back = int(rng_p.integers(0, 6))
            rng_r.integers(0, 6)
            head = port.head
            target = types.EVersion(head.epoch, max(0, head.version - back))
            seen = []
            fp.arm("pglog.rewind", seen.append)
            dp = port.rewind_to(target)
            assert fp.hits("pglog.rewind") == (1 if dp else 0)
            fp.disarm_all()
            dr = ref.rewind_to(ref_types.EVersion(target.epoch,
                                                  target.version))
            assert seen == ([{"_name": "pglog.rewind", "target": str(target),
                              "n": len(dp)}]
                            if dp else [])
            rewinds += bool(dp)
            assert [_fields(e) for e in dp] == [_fields(e) for e in dr]
            for key in port.omap_removals(dp):
                del omap_p[key]
            for key in ref.omap_removals(dr):
                del omap_r[key]
            version = port.head.version
            epoch = port.head.epoch
        assert omap_p == omap_r, f"step {step} ({action})"
        assert [_fields(e) for e in port.entries] == \
            [_fields(e) for e in ref.entries]
        assert (port.head, port.tail) == (
            types.EVersion(ref.head.epoch, ref.head.version),
            types.EVersion(ref.tail.epoch, ref.tail.version))
        # each package reads the other's rows, with rollback rows among
        # them (the "rb_" keys stay out of the scan)
        mixed = dict(omap_p)
        mixed[pglog.rollback_key(port.head, 2)] = b"rb"
        fp_, fr = pglog.PGLog.from_omap(mixed), ref_pglog.PGLog.from_omap(
            mixed)
        assert [_fields(e) for e in fp_.entries] == \
            [_fields(e) for e in fr.entries]
        assert (fp_.head.version, fp_.tail.version) == (
            fr.head.version, fr.tail.version)
    assert rewinds > 0


def test_queries_equal_the_reference():
    rng = np.random.default_rng(9)
    port, ref = pglog.PGLog(), ref_pglog.PGLog()
    for v in range(1, 41):
        port.append(_entry(types, np.random.default_rng(v), 2, v, v - 1))
        ref.append(_entry(ref_types, np.random.default_rng(v), 2, v, v - 1))
    port.trim_to(30)
    ref.trim_to(30)
    for _ in range(20):
        v = int(rng.integers(0, 45))
        pe = port.entries_after(types.EVersion(2, v))
        re_ = ref.entries_after(ref_types.EVersion(2, v))
        assert (pe is None) == (re_ is None)
        if pe is not None:
            assert [_fields(e) for e in pe] == [_fields(e) for e in re_]
        pc = port.objects_changed_after(types.EVersion(2, v))
        rc = ref.objects_changed_after(ref_types.EVersion(2, v))
        assert (pc is None) == (rc is None)
        if pc is not None:
            assert {k: _fields(e) for k, e in pc.items()} == \
                {k: _fields(e) for k, e in rc.items()}
    for i in range(10):
        pl, rl = port.latest_for(f"obj-{i}"), ref.latest_for(f"obj-{i}")
        assert (pl is None and rl is None) or _fields(pl) == _fields(rl)
    assert len(port) == len(ref) == 30


def test_rollback_keys_equal_the_reference():
    for ep, v, shard in ((0, 0, 0), (7, 123, 11), (4294967295, 2**40, 3)):
        pv, rv = types.EVersion(ep, v), ref_types.EVersion(ep, v)
        assert pglog.rollback_key(pv, shard) == \
            ref_pglog.rollback_key(rv, shard)
        assert pglog.rollback_prefix(pv) == ref_pglog.rollback_prefix(rv)
        assert pglog.rollback_key(pv, shard).startswith(
            pglog.rollback_prefix(pv))


def test_append_must_advance():
    log = pglog.PGLog()
    log.append(_entry(types, np.random.default_rng(0), 1, 5, 4))
    with pytest.raises(ValueError):
        log.append(_entry(types, np.random.default_rng(1), 1, 5, 4))
    assert log.rewind_to(types.EVersion(1, 9)) == []  # nothing divergent
