"""``chip_smoke.run_cluster``, the ``cluster`` phase's code, on the CPU at
a small size: the port's ``RadosClient`` over six port OSD daemons (isa
k=4 m=2 over all six, a replicated pool of size 3, eight PGs each) on
one map, with ``device="cpu"`` (each kernel's plain version).  The phase's own checks run: every reply 0, every
stored shard equal to the plain encode and its ``hinfo`` to the host
CRC, the replicated copies on every holder, the writes in flight to a
daemon that dies answered 0 with one log entry a reqid, the degraded
read byte for byte with a decode for every object that lost a data
shard, the striped object whole and at an unaligned offset with its
component objects' shards equal to the plain encode, and no thread left
after the shutdown.  On the card the same code runs in
``tests/test_torch_cuda.py -k cluster`` and, at full width, in
``chip_smoke.py``.
"""

import torch

import chip_smoke

SMALL = dict(n_osds=6, profile="plugin=isa k=4 m=2 technique=reed_sol_van",
             nobj=8, obj_bytes=64 << 10, stripe_bytes=16 << 10, rep_objs=4,
             rep_bytes=4096, threads=4, pg_num=8, inflight=4,
             striped=(1 << 20, 64 << 10, 4, 256 << 10))


def test_cluster_phase_on_the_cpu():
    res = chip_smoke.run_cluster(torch, "cpu", **SMALL)
    st = res["steps"]
    assert list(st) == ["boot", "write", "failover", "read", "stripe"]
    assert [r["step"] for r in res["refresh"]] == ["boot", "kill"]
    assert [r["daemons"] for r in res["refresh"]] == [6, 5]
    # the plain versions count no launch: only the card's kernels do
    assert all(not any(s["counts"].values()) for s in st.values())
    assert res["k6_per_target"] == 0
    # the objecter placed every op: at least one target a write and a read
    assert st["write"]["objecter_k6"] >= 8 + 4
    assert st["read"]["objecter_k6"] >= 8 + 4 + 4
    assert st["write"]["ec_shards_checked"] == 8 * 6
    # the failover ops in flight at the kill went out again to the new
    # primary
    fo = st["failover"]
    assert fo["objects"] == 4 and fo["resent_ops"] >= 1
    assert fo["ec_shards_checked"] == 4 * 5
    assert st["read"]["dec_jobs"] >= st["read"]["lost_data_objects"] > 0
    assert st["stripe"]["objects"] == 4
    assert st["stripe"]["ec_shards_checked"] == 4 * 5
