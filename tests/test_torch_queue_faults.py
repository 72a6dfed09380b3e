"""The port's stripe-batch queue refuses, at submit, the jobs its batches
cannot run, where the JAX queue fails inside its worker:

- a ``dec`` job for a codec whose recovery is not one MDS matrix product
  (shec: its coding matrix is not MDS, and k=8 m=4 c=3 with data shards
  0, 1, 2 lost has a singular k x k survivor matrix);
- an ``enc``/``encp`` job for a codec without ``encode_planes`` (lrc,
  which encodes through ``encode_array``).

The reads and writes those codecs do take (``decode_array``,
``encode_array``) still match ceph_tpu, and the RS decode through the
queue still matches it bit for bit."""

import numpy as np
import pytest

from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu.tpu.queue import StripeBatchQueue as RefQueue
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.gpu.queue import StripeBatchQueue

SHEC = "plugin=shec k=8 m=4 c=3"
LRC = "plugin=lrc k=4 m=2 l=3"


def _data(seed, k, n):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


@pytest.fixture
def queue():
    q = StripeBatchQueue(device="cpu", window_s=0.01)
    yield q
    q.stop()


@pytest.mark.parametrize("lost", [(0, 1, 2), (8, 9, 10), (0, 5, 11)])
def test_shec_decode_is_refused_at_submit(queue, lost):
    codec = codec_from_profile(SHEC, device="cpu")
    ref = ref_codec_from_profile(SHEC)
    data = _data(sum(lost), 8, 4096)
    full = np.concatenate([data, codec.encode_array(data)])
    avail = {i: full[i] for i in range(12) if i not in lost}
    with pytest.raises(TypeError, match="codec.decode"):
        queue.decode_data_async(codec, avail)
    assert queue.jobs == 0 and queue._thread is None  # nothing was queued
    got = codec.decode_array(avail, list(range(8)), 4096)
    want = ref.decode_array(avail, list(range(8)), 4096)
    for s in range(8):
        assert np.array_equal(got[s], np.asarray(want[s]))
        assert np.array_equal(got[s], data[s])


@pytest.mark.parametrize("route", ["encode_array", "encode"])
@pytest.mark.parametrize("submit", ["encode_async", "encode_crc_async"])
def test_lrc_encode_is_refused_at_submit(queue, submit, route):
    codec = codec_from_profile(LRC, device="cpu")
    with pytest.raises(TypeError, match="ErasureCodeLrc.*encode_array"):
        getattr(queue, submit)(codec, np.zeros((4, 4096), np.uint8))
    assert queue.jobs == 0 and queue._thread is None
    # lrc still encodes as the reference's chunks: through encode_array,
    # as the refusal advises, and through the byte API
    ref = ref_codec_from_profile(LRC)
    payload = _data(7, 1, 4 * 4096).tobytes()
    n = codec.get_chunk_count()
    want = ref.encode(range(n), payload)
    if route == "encode_array":
        planes, _ = codec.encode_prepare(payload)
        data_pos = [codec.chunk_index(i) for i in range(codec.k)]
        coding_pos = [c for c in range(n) if c not in data_pos]
        got = dict(zip(coding_pos, codec.encode_array(planes)))
        got.update(zip(data_pos, planes))
    else:
        got = codec.encode(range(n), payload)
    assert sorted(got) == sorted(want)
    for s in got:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s]))


@pytest.mark.parametrize("profile", [
    "plugin=isa k=8 m=4 technique=reed_sol_van",
    "plugin=isa k=4 m=2 technique=cauchy",
    "plugin=jerasure k=6 m=3 technique=reed_sol_van"])
def test_rs_decode_through_the_queue_still_matches_reference(queue,
                                                            profile):
    codec = codec_from_profile(profile, device="cpu")
    ref = ref_codec_from_profile(profile)
    k, m = codec.k, codec.m
    assert codec.mds_recovery
    widths = [4096, 1000, 3]
    rq = RefQueue()
    try:
        futs, wants = [], []
        for w in widths:
            data = _data(w + k, k, w)
            full = np.concatenate([data, codec.encode_array(data)])
            avail = {i: full[i] for i in range(m, k + m)}  # first m lost
            futs.append(queue.decode_data_async(codec, avail))
            wants.append((data, rq.decode_data_async(ref, avail)))
        for f, (data, rf) in zip(futs, wants):
            got = f.result(timeout=60)
            assert np.array_equal(got, np.asarray(rf.result(timeout=60)))
            assert np.array_equal(got, data)
    finally:
        rq.stop()


def test_bitmatrix_and_lrc_decode_stay_refused(queue):
    cg = codec_from_profile("plugin=jerasure k=4 m=2 technique=cauchy_good",
                            device="cpu")
    lrc = codec_from_profile(LRC, device="cpu")
    for codec in (cg, lrc):
        with pytest.raises(TypeError, match="codec.decode"):
            queue.decode_data_async(codec, {i: np.zeros(64, np.uint8)
                                            for i in range(codec.k)})
