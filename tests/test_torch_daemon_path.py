"""``chip_smoke.run_daemon``, the ``daemon`` phase's code, on the CPU at
a small size: six port OSD daemons (isa k=4 m=2 over all six, a
replicated pool of size 3, four PGs each) on one map, with
``device="cpu"`` (each kernel's plain version).  The phase's own checks
run: the boot warmup of every declared bucket before the messengers
serve, every reply 0, every stored shard equal to the plain encode and
its ``hinfo`` to the host CRC, every PG's ``last_update`` agreed on its
holders, the client ops counted by each primary's qos and kept in its
op history, the degraded read byte for byte with a decode for every
object that lost a data shard, the revived daemon caught up (its pool B
PG pulled from a peer, every shard of it equal to the plain encode,
``missing`` empty everywhere), the scheduled deep scrub naming the
marked shard, and no thread left after the shutdown.  On the card the
same code runs in ``tests/test_torch_cuda.py -k daemon`` and, at full
width, in ``chip_smoke.py``.
"""

import torch

import chip_smoke

SMALL = dict(n_osds=6, profile="plugin=isa k=4 m=2 technique=reed_sol_van",
             nobj=8, obj_bytes=64 << 10, stripe_bytes=16 << 10, rep_objs=4,
             rep_bytes=4096, overwrite=(2, 2), threads=4, pg_num=4)


def test_daemon_phase_on_the_cpu():
    res = chip_smoke.run_daemon(torch, "cpu", **SMALL)
    st = res["steps"]
    assert list(st) == ["warmup", "write", "kill", "read", "write_down",
                        "recover", "scrub"]
    assert res["warmup"]["done"] and res["warmup"]["buckets_warmed"] == 13
    assert [r["step"] for r in res["refresh"]] == ["boot", "kill",
                                                  "revive_addr", "revive"]
    assert [r["daemons"] for r in res["refresh"]] == [6, 5, 6, 6]
    # the plain versions count no launch: only the card's kernels do
    assert all(not any(s["counts"].values()) for s in st.values())
    assert st["write"]["ec_shards_checked"] == 8 * 6
    assert sum(st["write"]["admitted_client"].values()) >= 8 + 4
    assert st["read"]["dec_jobs"] >= st["read"]["lost_data_objects"] > 0
    assert any(p.startswith("1.") for p, _ in st["recover"]["pulls"])
    assert st["recover"]["ec_shards_checked"] == 8
    assert st["scrub"]["admitted_scrub"] > 0
    assert any("deep-scrub" in e for e in st["scrub"]["errors"])
