"""``chip_smoke.run_vstart``, the ``vstart`` phase's code, on the CPU at
a small size: three port mons on LSMStores and six port OSD daemons on
BlockStores (``VStartCluster`` with ``data_dir``, ``warmup=True``), an
EC pool of isa k=4 m=2 made through the mons, 8 objects of 64 KiB
written by the port's ``RadosClient``, with ``device="cpu"`` (each
kernel's plain version).  The phase's own checks run: every daemon up in
the leader's map, every stored shard equal to the plain encode and its
``hinfo`` to the host CRC, the leader's relay of a deep scrub, a new
leader after the leader's loss with a ``config set`` committed through
it on every live mon and the writes going on, a lost daemon marked down
from failure reports, the degraded read byte for byte with a decode for
every object that lost a data shard, the killed mon restarted from its
store directory at the leader's committed version, and no thread left
after the shutdown.  The mgr steps run too: the mgr started with its
dashboard over HTTP (every PG of the pool in ``/api/pgs``, ``/metrics``),
the port's ``ObjBencher`` on the pool and the port's ``ceph`` dispatch
(``ops latency`` counting the bench's ops), the dashboard's health naming
the lost daemon's ``OSD_DOWN`` after the leader's loss, the port's
``objectstore_tool`` exporting object 0's PG from the lost daemon's
BlockStore and ``monstore_tool`` reading the killed mon's version before
it restarts.  The device watch's checks run too: every first launch of
K1, the CRC and K6 up to the pool is its daemons' warmup, none rogue,
the write and the degraded read run under the steady-state guard with
no first launch, ``/metrics`` carries ``ceph_xla_compile_total`` of the
three, and no recompile storm is raised.  On the card the same code runs in
``tests/test_torch_cuda.py -k vstart`` and, at full width, in
``chip_smoke.py``.
"""

import torch

import chip_smoke

SMALL = dict(n_osds=6, profile="plugin=isa k=4 m=2 technique=reed_sol_van",
             nobj=8, obj_bytes=64 << 10, stripe_bytes=16 << 10, threads=4)


def test_vstart_phase_on_the_cpu():
    res = chip_smoke.run_vstart(torch, "cpu", **SMALL)
    st = res["steps"]
    assert list(st) == ["boot", "pool", "write", "relay", "mgr",
                        "leader_loss", "osd_loss", "mgr_health", "read",
                        "objectstore_tool", "monstore_tool", "mon_restart",
                        "shutdown"]
    # the plain versions count no launch: only the card's kernels do
    assert all(not any(s["counts"].values()) for s in st.values()
               if "counts" in s)
    assert st["boot"]["leader"] == 0
    assert len(st["boot"]["warmup_s"]) == 6
    assert st["write"]["ec_shards_checked"] == 8 * 6
    assert st["write"]["objecter_k6"] >= 8
    assert st["leader_loss"]["killed"] == 0
    assert st["leader_loss"]["leader"] == 1
    assert st["read"]["dec_jobs"] >= st["read"]["lost_data_objects"] > 0
    assert st["mon_restart"]["rank"] == 0
    assert st["mon_restart"]["last_committed"] == \
        st["mon_restart"]["leader_committed"]
    assert res["store_bytes"]["mon0"] > 0 and res["store_bytes"]["osd0"] > 0
    mg = st["mgr"]
    assert mg["bench"]["write"]["total_ops"] > 0
    assert mg["bench"]["seq"]["total_ops"] > 0
    assert mg["bench"]["write"]["errors"] == mg["bench"]["seq"]["errors"] == 0
    assert mg["ops_counted"] >= (mg["bench"]["write"]["total_ops"]
                                 + mg["bench"]["seq"]["total_ops"])
    assert mg["tree_nodes"] > 6 and mg["mgr_daemons"] == ["cluster"]
    assert st["mgr_health"]["osd_down"] == "1 osds down"
    assert st["mgr_health"]["feed_leader"] == st["leader_loss"]["leader"]
    assert st["objectstore_tool"]["objects"] >= 1
    assert st["objectstore_tool"]["hinfo_checked"] >= 1
    assert st["monstore_tool"]["rank"] == st["leader_loss"]["killed"]
    assert st["monstore_tool"]["last_committed"] == \
        st["mon_restart"]["loaded_version"]
    wt = res["watch"]
    assert all(r["class"] == "warmup" for r in wt["pool_first_launches"]
               if r["family"] in chip_smoke.WATCHED)
    assert st["write"]["guard"] == [] and st["read"]["guard"] == []
    assert wt["storms"] == 0
    assert all(n >= 1 for n in st["mgr"]["xla_compiles"].values())
    assert wt["warmup"]["done"]
