"""``chip_smoke.run_daemon``, the ``daemon`` phase's code, on the CPU at
a small size: six port OSD daemons on BlockStores (isa k=4 m=2 over all
six, a replicated pool of size 3, four PGs each) on one map, with
``device="cpu"`` (each kernel's plain version).  The phase's own checks
run: the boot warmup of every declared bucket before the messengers
serve, every reply 0, every stored shard equal to the plain encode and
its ``hinfo`` to the host CRC, every PG's ``last_update`` agreed on its
holders, the client ops counted by each primary's qos and kept in its
op history, the offset writes' ranged sub-reads served from the stores'
checksums at rest, the degraded read byte for byte with a decode for
every object that lost a data shard, the revived daemon on a new
BlockStore mounted from its directory and caught up (its pool B PG
pulled from a peer, every shard of it equal to the plain encode,
``missing`` empty everywhere), real rot in a block file refused by the
read, named by the scheduled deep scrub and healed by the repair, and no
thread left after the shutdown.  On the card the same code runs in
``tests/test_torch_cuda.py -k daemon`` and, at full width, in
``chip_smoke.py``.
"""

import sys

import torch

import chip_smoke
from ceph_tpu_torch.gpu import shapebucket as sb
from ceph_tpu_torch.osd.pg import PG

SMALL = dict(n_osds=6, profile="plugin=isa k=4 m=2 technique=reed_sol_van",
             nobj=8, obj_bytes=64 << 10, stripe_bytes=16 << 10, rep_objs=4,
             rep_bytes=4096, overwrite=(2, 2), threads=4, pg_num=4)


def _check_phase(res) -> dict:
    st = res["steps"]
    assert list(st) == ["warmup", "write", "rmw", "kill", "read",
                        "write_down", "recover", "rot_read", "scrub",
                        "repair"]
    assert res["warmup"]["done"] and \
        res["warmup"]["buckets_warmed"] == 3 * len(sb.WARM_COLS) + 1
    assert [r["step"] for r in res["refresh"]] == ["boot", "kill",
                                                  "revive_addr", "revive"]
    assert [r["daemons"] for r in res["refresh"]] == [6, 5, 6, 6]
    # the plain versions count no launch: only the card's kernels do
    assert all(not any(s["counts"].values()) for s in st.values())
    assert st["write"]["ec_shards_checked"] == 8 * 6
    assert sum(st["write"]["admitted_client"].values()) >= 8 + 4
    # no O_SYNC: the apply is the commit point, no device fsync
    assert st["write"]["queued_txns"] > 0 and st["write"]["dev_fsyncs"] == 0
    assert st["rmw"]["extent_reads_at_rest"] > 0
    assert st["rmw"]["extent_reads_whole_chunk"] == 0
    assert st["rmw"]["ec_shards_checked"] == 4 * 6
    assert st["read"]["dec_jobs"] >= st["read"]["lost_data_objects"] > 0
    assert any(p.startswith("1.") for p, _ in st["recover"]["pulls"])
    assert st["recover"]["ec_shards_checked"] == 8
    assert st["rot_read"]["dec_jobs"] >= 1 and st["rot_read"]["errors"]
    assert st["scrub"]["admitted_scrub"] > 0
    assert any("deep-scrub" in e for e in st["scrub"]["errors"])
    assert st["repair"]["post_errors"] == []
    assert st["repair"]["ec_shards_checked"] == 1
    assert res["store_bytes"]["block"] > 0 and res["store_bytes"]["meta.kv"]
    return st


def test_daemon_phase_on_the_cpu():
    _check_phase(chip_smoke.run_daemon(torch, "cpu", **SMALL))


def test_daemon_phase_retries_a_failed_laggard_push(monkeypatch):
    """The first push that a primary's activation sends to the revived
    daemon (a laggard: its log is behind) fails, as one lost to a kill
    window or timed out behind a slow store does.  The primary keeps the
    laggard stale and its watchdog pushes it forward again, so the phase
    passes every check: every holder's ``last_update`` agrees, and every
    shard and copy on the revived daemon equals what was written."""
    revived, failed = [], []
    real_revive = chip_smoke.DaemonSet.revive
    real_push = PG.push_object

    def revive(self, i, wrap=None, remount=False):
        revived.append(i)
        return real_revive(self, i, wrap, remount)

    def push_object(self, oid, to_osd):
        if (not failed and revived and to_osd == revived[0]
                and sys._getframe(1).f_code.co_name == "_push_laggards"):
            failed.append((str(self.pgid), oid))
            return False
        return real_push(self, oid, to_osd)

    monkeypatch.setattr(chip_smoke.DaemonSet, "revive", revive)
    monkeypatch.setattr(PG, "push_object", push_object)
    st = _check_phase(chip_smoke.run_daemon(torch, "cpu", **SMALL))
    assert len(failed) == 1
    assert st["recover"]["laggard_retries"] >= 1
