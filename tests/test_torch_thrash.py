"""The tier-1 cases of ``tests/test_thrash.py`` mirrored on the port's
cluster: random kill and revive cycles while the port's client keeps
writing and verifying; every object intact and right at the end.  Same
seeds, same rounds.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), the client ``torch_daemon_harness.LibClient``.  The
reference's wide-seed sweep (``test_thrash_ec_sweep``, marked slow
there) is not mirrored here.
"""

import random
import time

import torch_daemon_harness as H
from ceph_tpu_torch.osd import types as t_

REP_POOL, EC_POOL, N_OSDS = H.REP_POOL, H.EC_POOL, H.N_OSDS
LibClient = H.LibClient


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


def _patient_read(io, oid, timeout=20.0):
    """EAGAIN while an object's recovery is short of fresh shards is
    the CORRECT transient answer (serving stale bytes was the bug this
    test caught) — retry until recovery completes."""
    end = time.time() + timeout
    rep = None
    while time.time() < end:
        rep = io.operate(oid, [t_.OSDOp(t_.OP_READ)], timeout=timeout)
        if rep.result == 0:
            return rep.ops[0].out_data
        time.sleep(0.1)
    raise AssertionError(
        f"read {oid} timed out; last rc={rep.result if rep else None}")


def _thrash(pool: int, rounds: int, seed: int) -> None:
    rng = random.Random(seed)
    c = MiniCluster()
    cl = LibClient(c)
    expected = {}
    try:
        io = cl.rc.ioctx(pool)
        down = None
        for r in range(rounds):
            # IO burst
            for i in range(6):
                oid = f"t{rng.randrange(24)}"
                data = (f"{oid}-r{r}-{i}-".encode()
                        * rng.randrange(10, 120))
                rep = io.operate(
                    oid, [t_.OSDOp(t_.OP_WRITEFULL, data=data)],
                    timeout=20.0)
                assert rep.result == 0, (oid, rep.result)
                expected[oid] = data
            # verify a random sample mid-flight
            for oid in rng.sample(sorted(expected), min(4, len(expected))):
                assert _patient_read(io, oid) == expected[oid], f"mid {oid}"
            # thrash: revive any down osd, then kill a random one
            if down is not None:
                c.revive(down)
                down = None
            if rng.random() < 0.7:
                down = rng.randrange(N_OSDS)
                c.kill(down)
        if down is not None:
            c.revive(down)
        time.sleep(0.5)  # let the last re-peer settle
        for oid, data in sorted(expected.items()):
            assert _patient_read(io, oid) == data, f"final {oid}"
    finally:
        cl.shutdown()
        c.shutdown()


def test_thrash_replicated():
    _thrash(REP_POOL, rounds=8, seed=1234)


def test_thrash_ec():
    _thrash(EC_POOL, rounds=8, seed=4321)
