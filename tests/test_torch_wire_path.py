"""The wire slice as a whole on the CPU: ``chip_smoke.run_wire`` (the
``wire`` and ``recovery`` phases' own code) with ``device="cpu"`` at a
small size, held against ``ceph_tpu``.

The primary osd.0 and its peers are each the port's ``PG`` over a
MemStore behind a messenger.  Each object is a ``WRITEFULL`` ``MOSDOp``
from a client into ``PG.do_op``, staged in the queue's payload pool and
written through ``ECBackend.submit``: the plain kernels encode it with
its CRCs, the primary keeps its shards and sends each peer's PG one
``MECSubWriteVec`` whose transaction reads ``DeviceBuf`` handles, with
the PG log rows.  Each object is read back by a ``READ`` ``MOSDOp``
through ``_ec_read_object``: the peers' PGs serve ``MECSubRead`` through
the seals (one shard rotten by ``store.corrupt_chunk``, answered as
``ECRC``, and in the four-peer case one peer down), and
``reconstruct_async`` decodes.  In the four-peer case the primary then
loses its shards and ``PG.recovery_engine()`` rebuilds them, each equal
to the shard written.  The reference is ``ceph_tpu``'s
``codec.encode_array``, ``core.crc.crc32c``, ``codec.decode``,
``osd.backend.hinfo_decode`` and ``PGLog`` on the same objects: shards,
CRCs, every stored ``hinfo``, decoded bytes and every holder's log must
be exact.  The card's twin is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu.core.crc import crc32c as ref_crc32c
from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu.osd.backend import hinfo_decode as ref_hinfo_decode
from ceph_tpu.osd.pglog import PGLog as RefPGLog
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core import lockdep
from ceph_tpu_torch.osd.pglog import PGLog
from ceph_tpu_torch.store.objectstore import GHObject

K, M = 8, 4


@pytest.fixture(autouse=True)
def _restore_port_sanitizers():
    was = lockdep.enabled()
    fp.disarm_all()
    yield
    fp.disarm_all()
    lockdep.enable(was)
    lockdep.reset()


@pytest.mark.parametrize("peers,down,corrupt,lost", [
    (2, (), (1, 7), [7]),
    (4, (4,), (1, 6), [4, 6, 9]),
])
def test_wire_slice_on_the_cpu_matches_the_reference(peers, down, corrupt,
                                                     lost):
    # two peers: the primary's four shards and the rotten one are more
    # than m, so only the four-peer case can recover the primary's
    res = chip_smoke.run_wire(
        torch, torch.device("cpu"), nobj=4, obj_bytes=64 << 10,
        stripe_bytes=16 << 10, peers=peers, down=down, corrupt=corrupt,
        threads=2, recover=peers == 4)
    assert res["lost"] == lost
    assert res["acting"] == [s % (peers + 1) for s in range(K + M)]
    ref = ref_codec_from_profile(chip_smoke.WIRE_PROFILE)
    for i, obj in enumerate(res["objs"]):
        planes, _ = res["si"].interleave(obj)
        coding = res["coding"][i]
        assert np.array_equal(coding, ref.encode_array(planes))
        shards = list(planes) + list(coding)
        assert res["crcs"][i] == [ref_crc32c(s) for s in shards]
        chunks = {s: shards[s] for s in res["survivors"]}
        want = ref.decode(range(K), chunks)
        assert res["si"].deinterleave(
            np.stack([want[s] for s in range(K)]), len(obj)) == \
            obj.tobytes() == res["decoded"][i]
    # on the CPU the plain versions run: no kernel launch is counted
    assert not any(res["w_counts"].values())
    assert not any(res["r_counts"].values())
    width = res["coding"][0].shape[1]
    local = [s for s in range(K + M) if s % (peers + 1) == 0]
    remote_read = [s for s in res["survivors"] if s not in local]
    assert res["wire_bytes"] == [4 * (K + M - len(local)) * width,
                                 4 * len(remote_read) * width]
    assert res["seal_fails"] == 4 and res["refused"] >= 2
    assert res["sub_acks"] == 4 * peers
    # every stored shard after the write, and every remote survivor a
    # peer's PG served to the read (the primary's own are read inside
    # the PG's gather)
    assert res["verified"] == 4 * (K + M) + 4 * len(remote_read)
    assert sum(w * c for w, c in res["batch_jobs"].items()) == 4
    # lockdep was armed for the run and saw the queue's nested locks
    assert "staging.stats" in res["edge_graph"]["staging.pool"]
    assert "staging.stats" in res["edge_graph"]["staging.devbuf"]
    # the write staged each object, fetched each parity handle once (at
    # its local apply or its transaction's encode), made no unsanctioned
    # host copy and no host CRC in the backend, and applied the
    # primary's shards through op_payload before each seal
    dp = res["devpath"]
    assert dp["payload_host_touches"] == 0 and dp["write_host_crcs"] == 0
    assert dp["d2h_bytes"] == 4 * M * width
    assert dp["h2d_bytes"] == 4 * (64 << 10) and dp["staged_batches"] >= 1
    assert dp["occupancy_after"] == 0
    assert 0 < dp["pool_occupancy_hw"] <= min(2, chip_smoke.WIRE_SLOTS)
    assert dp["seals"] == 4 and dp["local_applied"] == 4 * len(local)
    assert res["devbuf"] == {"on": "cpu", "bytes": M * width,
                             "d2h_grew": M * width, "k1_launches": 0}
    # through the PG: every write staged, none degraded; every read
    # decoded on the queue (none served warm), the rotten shard counted
    # once an object; every PG's head at the last write
    assert res["staged"] == {"staged": 4, "degraded": 0}
    assert res["dec_jobs"] == 4 and res["scrub_errors"] == 4
    assert res["heads"] == {o: "7'4" for o in range(peers + 1)}
    rec = res["recovery"]
    if peers == 4:
        # the primary's shards 0, 5, 10 of 4 objects, one round of 3 and
        # one of 1, one vec a peer a round, every object decoded
        assert rec["shards"] == 12 and rec["rounds"] == 2
        assert rec["subread_msgs"] <= 4 * 2 and rec["dec_jobs"] == 4
        assert rec["bytes"] == 12 * width
        assert not any(rec["counts"].values())
    else:
        assert rec is None
    # every holder's PG log and stored hinfo: the reference reads the
    # same omap to the same entries, its own rows for them are the same
    # bytes, and its hinfo_decode reads the card's CRC of each shard
    assert sorted(res["pg_omaps"]) == list(range(peers + 1))
    for omap in res["pg_omaps"].values():
        port_log, ref_log = PGLog.from_omap(omap), RefPGLog.from_omap(omap)
        got = [(e.op, e.oid, e.version.epoch, e.version.version,
                e.prior_version.version, e.reqid) for e in port_log.entries]
        assert got == [(e.op, e.oid, e.version.epoch, e.version.version,
                        e.prior_version.version, e.reqid)
                       for e in ref_log.entries]
        assert [v for _, _, _, v, _, _ in got] == [1, 2, 3, 4]
        rows = {k: v for k, v in omap.items() if k[0].isdigit()}
        assert ref_log.omap_additions(ref_log.entries) == rows
        assert (port_log.head.version, port_log.tail.version) == (
            ref_log.head.version, ref_log.tail.version) == (4, 0)
    for num, hinfos in res["hinfos"].items():
        for (i, s), blob in hinfos.items():
            assert ref_hinfo_decode(blob) == (64 << 10, res["crcs"][i][s],
                                             True)


def test_scrub_phase_on_the_cpu():
    """The ``scrub`` phase's code (``run_wire``'s step 6) at six 64 KiB
    objects on the four-peer layout: the cls calls through ``do_op`` and
    their two re-encodes, a clean shallow pass (one ``MScrub`` a peer),
    a deep pass naming the rotten shard on every object (one
    ``MECSubRead`` a remote shard, one ``dec`` job an object), five
    marked shards auto-repaired (four by ``MPGPush``, the primary's
    through its store) and a clean last pass.  The stamps and cursor rows
    the engine left read the same through ``ceph_tpu``'s codec."""
    from ceph_tpu.core.encoding import Decoder as RefDecoder
    from ceph_tpu.osd.scrub import decode_stamps as ref_decode_stamps

    res = chip_smoke.run_wire(
        torch, torch.device("cpu"), nobj=6, obj_bytes=64 << 10,
        stripe_bytes=16 << 10, peers=4, down=(4,), corrupt=(1, 6),
        threads=2, scrub=True)
    scr = res["scrub"]
    steps = scr["steps"]
    width = scr["width"]
    assert width == res["coding"][0].shape[1]
    for s in steps.values():  # the plain versions: no launch counted
        assert not any(s["counts"].values())
    assert steps["cls"]["jobs"] == {"enc": 2, "encp": 0}
    assert steps["cls"]["sent"]["MECSubWriteVec"] == 2 * 4
    assert steps["shallow"]["sent"] == {"MScrub": 4}
    assert steps["shallow"]["got"] == {"MScrubMap": 4}
    assert steps["shallow"]["scrub_perf"] == {"objects": 6 * 5,
                                              "shallow_done": 1}
    remote = K + M - 3  # the primary holds shards 0, 5 and 10
    for name in ("deep", "final"):
        assert steps[name]["sent"] == {"MECSubRead": 6 * remote}
        assert steps[name]["dec_jobs"] == 6
        assert steps[name]["gathered_bytes"] == 6 * (K + M) * width
    assert steps["deep"]["scrub_perf"] == {"chunks": 1, "objects": 6,
                                           "errors_found": 6,
                                           "deep_done": 1}
    # the pass, the five repairs' gathers and their re-verification
    assert steps["repair"]["sent"] == {"MECSubRead": (6 + 5 + 5) * remote,
                                       "MPGPush": 4}
    assert steps["repair"]["scrub_perf"]["errors_repaired"] == 5
    assert scr["marked"] == [(f"rbd_data.{i:016x}", s)
                             for i, s in chip_smoke.SCRUB_MARKS]
    last_scrub, last_deep, errors = ref_decode_stamps(scr["stamps"])
    assert errors == 0 and last_deep == last_scrub > 0
    d = RefDecoder(scr["cursor"])
    assert (d.u8(), d.string()) == (0, "")
    assert scr["scrub_perf"]["deep_done"] == 3


def test_wire_trace_accounts_for_every_crc_byte_on_the_cpu():
    """``wire_trace.trace`` at the small size: each window's host CRC
    bytes by call site add up to what the phase moved (the store seals
    every stored shard once on write and verifies every shard a live
    peer reads, the rotten one too; every shard byte crosses a frame
    out and in), and the sampler saw the threads in both windows."""
    import wire_trace

    res = wire_trace.trace(
        torch, torch.device("cpu"), nobj=4, obj_bytes=64 << 10,
        stripe_bytes=16 << 10, peers=2, down=(), corrupt=(1, 7), threads=2)
    write, read = res["windows"]
    width = res["coding"][0].shape[1]
    # the store seals every shard once, the primary's too; reads verify
    # every shard read, the rotten one too, and the backend checks each
    # shard it serves against its hinfo
    assert write["crc"]["seal write"]["bytes"] == 4 * (K + M) * width
    assert read["crc"]["seal verify"]["bytes"] == 4 * (K + M) * width
    assert read["crc"]["hinfo verify"]["bytes"] == 4 * (K + M - 1) * width
    assert "hinfo verify" not in write["crc"]
    assert res["wire_bytes"][0] == 4 * 8 * width  # 8 of 12 shards remote
    assert res["wire_bytes"][1] == 4 * 7 * width
    for w, shard_bytes in ((write, res["wire_bytes"][0]),
                           (read, res["wire_bytes"][1])):
        assert w["crc"]["frame out"]["bytes"] >= shard_bytes
        assert w["crc"]["frame in"]["bytes"] >= shard_bytes
        assert 0 < w["crc_cpu_s"] and 0 < w["crc_s"] <= 8 * w["wall_s"]
        assert sum(w["samples"].values()) > 0
        assert "device" not in w  # the profiler runs only on a card
    assert "seal write" not in read["crc"]
    assert "seal verify" not in write["crc"]
    # the smoke's own functions are back in place
    assert chip_smoke.run_threads.__name__ == "run_threads"
