"""The port's failpoint registry (``ceph_tpu_torch/core/failpoint.py``),
case for case against the registry unit cases of
``tests/test_failpoints.py`` (``:53-110``), plus its point table against
the reference's and the routes that wait for later slices.

The reference's other cases need the filestore (queue 1 item 5) and the
MiniCluster (slice 1j).
"""

import threading
import time

import pytest

import ceph_tpu.core.failpoint as ref_fp
import ceph_tpu_torch.core.failpoint as fp


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.disarm_all()
    fp.seed(0)
    yield
    fp.disarm_all()
    fp.seed(0)


def test_registry_unknown_name_refused():
    with pytest.raises(KeyError):
        fp.arm("pg.totally.bogus", fp.sleep_ms(1))
    with pytest.raises(ValueError):
        fp.arm_from_spec("pg.commit.client_reply=explode")


def test_disarmed_is_noop_and_cheap():
    assert fp.failpoint("pg.commit.client_reply") is None
    assert not fp.enabled("pg.commit.client_reply")
    # the disarmed guard is one global load + None check; min of 5
    # batches against scheduler noise, the reference's 5 us bound
    n = 20000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fp.failpoint("pg.commit.client_reply")
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 5e-6, f"disarmed failpoint cost {best*1e9:.0f}ns"


def test_modifiers_once_count_prob_match():
    fp.arm("backend.commit.ack", fp.sleep_ms(0), count=2)
    for _ in range(5):
        fp.failpoint("backend.commit.ack")
    assert fp.fired("backend.commit.ack") == 2
    assert not fp.enabled("backend.commit.ack")  # self-disarmed

    fp.arm("pg.rollback.entry", fp.DROP_ACTION, match={"oid": "m2"})
    assert fp.failpoint("pg.rollback.entry", oid="m7") is None
    assert fp.failpoint("pg.rollback.entry", oid="m2") is fp.DROP
    fp.disarm("pg.rollback.entry")

    # seeded prob: same seed => identical firing pattern
    def pattern(seed):
        fp.disarm_all()
        fp.seed(seed)
        fp.arm("pglog.rewind", fp.DROP_ACTION, prob=0.5)
        return [fp.failpoint("pglog.rewind") is fp.DROP
                for _ in range(64)]

    a, b, c = pattern(0xD403), pattern(0xD403), pattern(0x1EC)
    assert a == b
    assert a != c  # different seed, different schedule


def test_error_and_dsl_roundtrip():
    fp.arm_from_spec("store.commit_batch.sync=error(RuntimeError):once")
    with pytest.raises(RuntimeError):
        fp.failpoint("store.commit_batch.sync")
    assert fp.failpoint("store.commit_batch.sync") is None  # once spent


def test_barrier_rendezvous_and_abort():
    fp.arm("queue.batch.dispatch", fp.barrier("hold-batch"))
    hit = []

    def worker():
        try:
            fp.failpoint("queue.batch.dispatch")
            hit.append("through")
        except fp.FailpointAborted:
            hit.append("aborted")

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    assert fp.wait_hit("hold-batch", timeout=5.0)
    assert not hit  # parked, deterministically
    fp.release("hold-batch")
    th.join(5.0)
    assert hit == ["through"]

    fp.arm("queue.batch.dispatch", fp.barrier("hold-batch2"))
    th2 = threading.Thread(target=worker, daemon=True)
    th2.start()
    assert fp.wait_hit("hold-batch2", timeout=5.0)
    fp.abort("hold-batch2")
    th2.join(5.0)
    assert hit == ["through", "aborted"]


# -- against ceph_tpu -----------------------------------------------------------


def test_points_equal_the_reference():
    assert list(fp.POINTS) == list(ref_fp.POINTS)
    assert fp.POINTS == ref_fp.POINTS


@pytest.mark.parametrize("seed", [0, 0xD403, 12345])
def test_seeded_streams_equal_the_reference(seed):
    """The same seed fires the same hits in both packages, and
    corrupt_bytes flips the same bits."""
    pats = []
    for mod in (fp, ref_fp):
        mod.disarm_all()
        mod.seed(seed)
        mod.arm_from_spec("pglog.rewind=drop:prob(0.3),"
                          "scrub.chunk=drop:prob(0.7):count(9)")
        pats.append(([mod.failpoint("pglog.rewind") is mod.DROP
                      for _ in range(128)],
                     [mod.failpoint("scrub.chunk") is mod.DROP
                      for _ in range(64)],
                     mod.hits("scrub.chunk"), mod.fired("scrub.chunk"),
                     mod.corrupt_bytes(bytes(range(256)) * 7, "o1:s2")))
        mod.disarm_all()
        mod.seed(0)
    assert pats[0] == pats[1]


def test_eio_waits_for_the_store_slice():
    """error(EIO) arms in both packages; firing it raises the store's
    StoreError in the reference and, until the port's store lands
    (slice 1c), an error that names that slice."""
    from ceph_tpu.store.objectstore import StoreError

    ref_fp.disarm_all()
    try:
        ref_fp.arm_from_spec("store.filestore.read=error(EIO):once")
        with pytest.raises(StoreError):
            ref_fp.failpoint("store.filestore.read")
    finally:
        ref_fp.disarm_all()
    assert fp.arm_from_spec("store.filestore.read=error(EIO):once") == \
        ["store.filestore.read"]
    with pytest.raises(NotImplementedError, match="slice 1c"):
        fp.failpoint("store.filestore.read")
    assert fp.fired("store.filestore.read") == 1
