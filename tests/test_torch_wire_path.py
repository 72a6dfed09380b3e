"""The wire slice as a whole on the CPU: ``chip_smoke.run_wire`` (the
``wire`` phase's own code) with ``device="cpu"`` at a small size, held
against ``ceph_tpu``.

The port's queue encodes with the plain kernels, the messenger carries
the shards to the peers under cephx, each peer's MemStore commits and
seals them, the peers read them back through the seals (one shard
rotten by ``store.corrupt_chunk``, and in the four-peer case one peer
down), and the queue decodes.  The reference is ``ceph_tpu``'s
``codec.encode_array``, ``core.crc.crc32c`` and ``codec.decode`` on the
same objects: shards, CRCs and decoded bytes must be exact.  The card's
twin is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu.core.crc import crc32c as ref_crc32c
from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core import lockdep

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
    (2, (), (1, 6), [6]),
    (4, (4,), (3, 6), [3, 6, 7, 11]),
])
def test_wire_slice_on_the_cpu_matches_the_reference(peers, down, corrupt,
                                                     lost):
    res = chip_smoke.run_wire(
        torch, torch.device("cpu"), nobj=4, obj_bytes=64 << 10,
        stripe_bytes=16 << 10, peers=peers, down=down, corrupt=corrupt,
        threads=2)
    assert res["lost"] == lost
    ref = ref_codec_from_profile(chip_smoke.WIRE_PROFILE)
    for i, obj in enumerate(res["objs"]):
        planes, coding = res["planes"][i], res["coding"][i]
        assert np.array_equal(coding, ref.encode_array(planes))
        shards = list(planes) + list(coding)
        assert res["crcs"][i] == [ref_crc32c(s) for s in shards]
        chunks = {s: shards[s] for s in res["survivors"]}
        want = ref.decode(range(K), chunks)
        assert np.array_equal(np.stack([want[s] for s in range(K)]),
                              res["decoded"][i])
        assert res["si"].deinterleave(res["decoded"][i], len(obj)) == \
            obj.tobytes()
    # on the CPU the plain versions run: no kernel launch is counted
    assert not any(res["w_counts"].values())
    assert not any(res["r_counts"].values())
    width = res["coding"][0].shape[1]
    assert res["wire_bytes"] == [4 * (K + M) * width,
                                 4 * (K + M - len(lost)) * width]
    assert res["seal_fails"] == 4 and res["refused"] >= 2
    assert res["sub_acks"] == 4 * peers
    assert res["verified"] == 4 * (K + M) + 4 * (K + M - len(lost))
    # lockdep was armed for the run and saw the queue's nested locks
    assert "staging.stats" in res["edge_graph"]["staging.pool"]


def test_wire_trace_accounts_for_every_crc_byte_on_the_cpu():
    """``wire_trace.trace`` at the small size: each window's host CRC
    bytes by call site add up to what the phase moved (the store seals
    every stored shard once on write and verifies every shard a live
    peer reads, the rotten one too; every shard byte crosses a frame
    out and in), and the sampler saw the threads in both windows."""
    import wire_trace

    res = wire_trace.trace(
        torch, torch.device("cpu"), nobj=4, obj_bytes=64 << 10,
        stripe_bytes=16 << 10, peers=2, down=(), corrupt=(1, 6), threads=2)
    write, read = res["windows"]
    width = res["coding"][0].shape[1]
    assert write["crc"]["seal write"]["bytes"] == res["wire_bytes"][0]
    assert read["crc"]["seal verify"]["bytes"] == 4 * (K + M) * width
    assert res["wire_bytes"][1] == 4 * (K + M - 1) * width
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
