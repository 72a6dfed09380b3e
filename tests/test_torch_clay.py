"""``tests/test_clay.py`` mirrored on the port's clay codec
(``ceph_tpu_torch/ec/clay.py``), case for case with the same
parametrisations, each case also held to ``ceph_tpu.ec.clay`` bit for
bit: the same chunks out of the encode, the same chunks out of every
repair and decode.  Codecs are built with ``device="cpu"`` (the plain
version of K1 runs every product); the card's twins are the ``clay``
cases of ``tests/test_torch_cuda.py``.

Beyond the mirror: every lost-shard index of k=4 m=2, k=8 m=4 and the
shortened k=5 m=3 against the reference, the tensor forms of
``repair_planes``/``decode_planes``, that every product of the codec
goes through ``ops.gf256.gf_matmul_bytes``, and that a codec with no
device refuses to build without a card.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec.clay import ClayCodec as RefClay
from ceph_tpu.ec.registry import instance as ref_registry
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.ec.clay import ClayCodec, ErasureCodeClay
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import instance as registry


def _clay(k, m, **kw):
    return ClayCodec(k=k, m=m, device="cpu", **kw)


def _roundtrip_codec(k, m, size=1 << 14, seed=0):
    codec = _clay(k, m)
    ref = RefClay(k=k, m=m)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    chunks = codec.encode(range(k + m), data)
    assert len(chunks) == k + m
    want = ref.encode(range(k + m), data)
    for i in range(k + m):
        np.testing.assert_array_equal(np.asarray(chunks[i]),
                                      np.asarray(want[i]))
    got = codec.decode_concat({i: chunks[i] for i in range(k)})
    assert got[: len(data)] == data
    return codec, data, chunks


def test_encode_decode_identity_k8m4():
    _roundtrip_codec(8, 4)


def test_encode_decode_identity_k4m2():
    _roundtrip_codec(4, 2)


def test_shortened_construction_k5m3():
    # k+m=8 not divisible by q=3 -> nu=1 virtual chunk
    codec, data, chunks = _roundtrip_codec(5, 3)
    assert codec.nu == 1
    assert codec.sub_count == codec.q ** codec.t


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (5, 3)])
def test_mds_random_erasures(k, m):
    """Any m erasures are decodable and every chunk is reproduced
    bit-exactly (data AND parity), as the reference decodes it."""
    codec, data, chunks = _roundtrip_codec(k, m, seed=k * 17 + m)
    ref = RefClay(k=k, m=m)
    rng = np.random.default_rng(99)
    for trial in range(6):
        n_erase = int(rng.integers(1, m + 1))
        erased = sorted(
            rng.choice(k + m, size=n_erase, replace=False).tolist())
        avail = {i: chunks[i] for i in range(k + m) if i not in erased}
        got = codec.decode(erased, avail)
        want = ref.decode(erased, avail)
        for e in erased:
            np.testing.assert_array_equal(
                np.asarray(got[e]), np.asarray(chunks[e]),
                err_msg=f"chunk {e} mismatch (erased={erased})")
            np.testing.assert_array_equal(np.asarray(got[e]),
                                          np.asarray(want[e]))


def test_repair_reads_fewer_bytes_than_rs():
    """Single-node repair reads d/(k*q) of the RS bytes — strictly less
    than k full chunks (the MSR point of clay)."""
    k, m = 8, 4
    codec, data, chunks = _roundtrip_codec(k, m)
    ref = RefClay(k=k, m=m)
    chunk_size = len(np.asarray(chunks[0]).ravel())
    for lost in (0, 3, 9, 11):  # data nodes and parity nodes
        helpers = [i for i in range(k + m) if i != lost]
        plan = codec.minimum_to_decode([lost], helpers)
        assert plan == ref.minimum_to_decode([lost], helpers)
        assert len(plan) == codec.d
        read = codec.repair_read_bytes([lost], helpers, chunk_size)
        rs_read = k * chunk_size
        assert read < rs_read, "clay repair must beat RS"
        assert read * k * codec.q == rs_read * codec.d
        got = codec.repair_chunk([lost], {h: chunks[h] for h in helpers})
        np.testing.assert_array_equal(
            np.asarray(got[lost]), np.asarray(chunks[lost]).ravel())


def test_repair_shortened_construction():
    """Repair with nu > 0 virtual chunks (k5m3): external chunk ids map
    to offset grid nodes, including parity repairs."""
    k, m = 5, 3
    codec, data, chunks = _roundtrip_codec(k, m, seed=11)
    chunk_size = len(np.asarray(chunks[0]).ravel())
    for lost in (0, 4, 5, 7):  # data and parity, around the nu gap
        helpers = [i for i in range(k + m) if i != lost]
        read = codec.repair_read_bytes([lost], helpers, chunk_size)
        assert read * k * codec.q == k * chunk_size * codec.d
        got = codec.repair_chunk([lost], {h: chunks[h] for h in helpers})
        np.testing.assert_array_equal(
            np.asarray(got[lost]), np.asarray(chunks[lost]).ravel(),
            err_msg=f"shortened repair of chunk {lost}")


def test_repair_from_subchunks_only():
    """The repair path works given ONLY the repair-layer sub-chunks —
    proving the reduced read is real, not an interface fiction."""
    k, m = 8, 4
    codec, data, chunks = _roundtrip_codec(k, m, seed=5)
    lost = 6
    layers = codec.repair_layers(lost)
    np.testing.assert_array_equal(layers,
                                  RefClay(k=k, m=m).repair_layers(lost))
    s = len(np.asarray(chunks[0]).ravel()) // codec.sub_count
    picks = {}
    for h in range(k + m):
        if h == lost:
            continue
        full = np.asarray(chunks[h], dtype=np.uint8).reshape(
            codec.sub_count, s)
        picks[h] = full[layers].copy()  # only 1/q of the chunk
    got = codec.repair_chunk([lost], picks, layers_only=True)
    np.testing.assert_array_equal(
        np.asarray(got[lost]), np.asarray(chunks[lost]).ravel())


def test_minimum_to_decode_subchunk_runs():
    codec = _clay(8, 4)
    plan = codec.minimum_to_decode([2], [i for i in range(12) if i != 2])
    assert plan == RefClay(k=8, m=4).minimum_to_decode(
        [2], [i for i in range(12) if i != 2])
    total = codec.sub_count // codec.q
    for h, runs in plan.items():
        assert sum(c for _, c in runs) == total
        # runs are disjoint, sorted, in-range
        last = -1
        for off, cnt in runs:
            assert off > last
            last = off + cnt - 1
            assert 0 <= off and off + cnt <= codec.sub_count


def test_registry_clay_factory():
    codec = registry().factory("clay", {"k": "4", "m": "2"}, device="cpu")
    ref = ref_registry().factory("clay", {"k": "4", "m": "2"})
    assert codec.get_sub_chunk_count() == codec.q ** codec.t
    assert codec.profile == ref.profile
    assert codec.get_alignment() == ref.get_alignment()
    data = bytes(range(256)) * 8
    chunks = codec.encode(range(6), data)
    got = codec.decode_concat({i: chunks[i] for i in (1, 2, 4, 5)})
    assert got[: len(data)] == data


def test_bad_params_rejected():
    with pytest.raises(ErasureCodeError):
        _clay(4, 2, d=4)  # d != k+m-1
    with pytest.raises(ErasureCodeError):
        _clay(4, 2, gamma=1)


# ---------------------------------------------------------------------------
# beyond the mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m,s", [(4, 2, 12), (8, 4, 3), (5, 3, 7)])
def test_every_lost_shard_matches_reference(k, m, s):
    """Every lost-shard index (external ids, so the shortened k5m3's
    parity ids sit past the virtual node) through repair_chunk and the
    general decode, against the reference codec."""
    codec, ref = _clay(k, m), RefClay(k=k, m=m)
    rng = np.random.default_rng(k * 101 + m)
    data = rng.integers(0, 256, (k, codec.sub_count * s), dtype=np.uint8)
    parity = codec.encode_array(data)
    np.testing.assert_array_equal(parity, np.asarray(ref.encode_array(data)))
    chunks = list(data) + list(parity)
    for lost in range(k + m):
        helpers = {h: chunks[h] for h in range(k + m) if h != lost}
        got = codec.repair_chunk([lost], helpers)[lost]
        np.testing.assert_array_equal(
            got, np.asarray(ref.repair_chunk([lost], helpers)[lost]))
        np.testing.assert_array_equal(got, chunks[lost])
        # the same shard lost together with the m-1 after it: the
        # general decode in intersection-score order
        erased = sorted({(lost + j) % (k + m) for j in range(m)})
        avail = {i: chunks[i] for i in range(k + m) if i not in erased}
        out = codec.decode_array(avail, erased, codec.sub_count * s)
        want = ref.decode_array(avail, erased, codec.sub_count * s)
        for e in erased:
            np.testing.assert_array_equal(out[e], np.asarray(want[e]))


def test_planes_entries_take_tensors_and_numpy():
    """repair_planes and decode_planes on tensors of the codec's device
    give tensors; on numpy they give numpy; both equal the reference."""
    k, m, s = 4, 2, 6
    codec, ref = _clay(k, m), RefClay(k=k, m=m)
    data = np.random.default_rng(3).integers(
        0, 256, (k, codec.sub_count * s), dtype=np.uint8)
    chunks = list(data) + list(codec.encode_array(data))
    lost, helpers = 1, [0, 2, 3, 4, 5]
    layers = codec.repair_layers(lost)
    planes = np.stack([chunks[h].reshape(codec.sub_count, s)[layers]
                       for h in helpers])
    want = np.asarray(ref.repair_planes(lost, helpers, planes))
    t = codec.repair_planes(lost, helpers, torch.from_numpy(planes))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(
        codec.repair_planes(lost, helpers, planes), want)
    avail = [2, 3, 4, 5]
    stacked = np.stack([chunks[i] for i in avail])
    want = np.asarray(ref.decode_planes(avail, stacked))
    np.testing.assert_array_equal(
        codec.decode_planes(avail, torch.from_numpy(stacked)).numpy(), want)
    np.testing.assert_array_equal(codec.decode_planes(avail, stacked), want)


def test_every_product_goes_through_k1(monkeypatch):
    """The pair transforms, the MDS product and the solves all call
    ``ops.gf256.gf_matmul_bytes`` (K1 on the card); nothing else
    multiplies."""
    from ceph_tpu_torch.ops import gf256

    calls = []
    real = gf256.gf_matmul_bytes

    def counted(matrix, x, *a, **kw):
        calls.append(np.asarray(matrix).shape)
        return real(matrix, x, *a, **kw)

    monkeypatch.setattr(gf256, "gf_matmul_bytes", counted)
    monkeypatch.setattr(torch, "matmul", None)
    codec = _clay(8, 4)
    data = np.random.default_rng(1).integers(
        0, 256, (8, codec.sub_count * 4), dtype=np.uint8)
    chunks = list(data) + list(codec.encode_array(data))
    codec.repair_chunk([0], {h: chunks[h] for h in range(1, 12)})
    codec.decode_array({i: chunks[i] for i in range(4, 12)},
                       [0, 1, 2, 3], codec.sub_count * 4)
    assert calls and len(calls) == codec.products
    assert {(1, 2), (4, 8)} <= set(calls)  # pair transforms, solves
    assert (4, 8) in calls                 # the MDS coding product
    assert not codec.supports_partial_writes()
    assert codec.mds_recovery is False


def test_clay_profile_needs_a_device_or_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        codec_from_profile("plugin=clay k=8 m=4")
    codec = ErasureCodeClay.create({"k": "8", "m": "4", "d": "11"},
                                   device="cpu")
    assert (codec.q, codec.t, codec.get_sub_chunk_count()) == (4, 3, 64)
