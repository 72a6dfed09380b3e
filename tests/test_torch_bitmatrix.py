"""The port's jerasure bit-matrix techniques (BitmatrixCodec on the GF(2)
product) held against ceph_tpu.ec on the CPU, bit for bit: the same
generator bit-matrices, chunk sizes and profiles, and the same encode,
decode, decode_concat and minimum_to_decode under every erasure pattern
of up to m chunks."""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import instance as ref_instance
from ceph_tpu.ec import jerasure as ref_jerasure
from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu_torch.ec import ErasureCodeError, instance, jerasure
from ceph_tpu_torch.ec.codec import BitmatrixCodec

TECHNIQUES = [
    ("cauchy_orig", 4, 2, 8),
    ("cauchy_good", 6, 3, 8),
    ("liberation", 4, 2, 7),
    ("blaum_roth", 4, 2, 6),
    ("liber8tion", 6, 2, 8),
]


def _pair(technique, k, m, w):
    prof = {"technique": technique, "k": str(k), "m": str(m), "w": str(w)}
    return (instance().factory("jerasure", dict(prof), device="cpu"),
            ref_instance().factory("jerasure", dict(prof)))


@pytest.mark.parametrize("technique,k,m,w", TECHNIQUES)
def test_generator_bitmatrices_equal_reference(technique, k, m, w):
    port, ref = _pair(technique, k, m, w)
    assert isinstance(port, BitmatrixCodec)
    assert (port.k, port.m, port.w) == (ref.k, ref.m, ref.w)
    assert port.coding_bits.dtype == ref.coding_bits.dtype
    assert port.coding_bits.tobytes() == ref.coding_bits.tobytes()
    assert port.full_bits.tobytes() == ref.full_bits.tobytes()
    assert port.profile == ref.profile
    assert port.get_alignment() == ref.get_alignment()
    for size in (0, 1, 1000, 4096, 1 << 20, 3_000_001):
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)


@pytest.mark.parametrize("technique,k,m,w", TECHNIQUES)
def test_encode_decode_every_erasure_pattern(technique, k, m, w):
    port, ref = _pair(technique, k, m, w)
    n = k + m
    rng = np.random.default_rng(k * 100 + m * 10 + w)
    payload = rng.integers(0, 256, 5001, dtype=np.uint8).tobytes()
    got = port.encode(range(n), payload)
    want = ref.encode(range(n), payload)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    for lost in itertools.chain.from_iterable(
            itertools.combinations(range(n), e) for e in range(1, m + 1)):
        avail = {i: got[i] for i in range(n) if i not in lost}
        dec = port.decode(range(n), avail)
        rdec = ref.decode(range(n), {i: want[i] for i in avail})
        for i in range(n):
            assert np.array_equal(dec[i], np.asarray(rdec[i])), (lost, i)
            assert np.array_equal(dec[i], got[i]), (lost, i)
        concat = port.decode_concat(avail)
        assert concat == ref.decode_concat({i: want[i] for i in avail})
        assert concat[:len(payload)] == payload
        assert port.minimum_to_decode(range(k), avail) == \
            ref.minimum_to_decode(range(k), avail)


@pytest.mark.parametrize("technique,k,w", [("liberation", 5, 5),
                                           ("liberation", 7, 7),
                                           ("blaum_roth", 6, 10),
                                           ("liber8tion", 8, 8)])
def test_wider_constructions_equal_reference(technique, k, w):
    if technique == "liberation":
        pair = (jerasure.liberation_bitmatrix(k, w),
                ref_jerasure.liberation_bitmatrix(k, w))
    elif technique == "blaum_roth":
        pair = (jerasure.blaum_roth_bitmatrix(k, w),
                ref_jerasure.blaum_roth_bitmatrix(k, w))
    else:
        pair = (jerasure.liber8tion_bitmatrix(k),
                ref_jerasure.liber8tion_bitmatrix(k))
    assert pair[0].tobytes() == pair[1].tobytes()
    port, ref = _pair(technique, k, 2, w)
    payload = bytes(range(256)) * 23
    got, want = port.encode(range(k + 2), payload), ref.encode(
        range(k + 2), payload)
    for i in range(k + 2):
        assert np.array_equal(got[i], want[i])
    avail = {i: got[i] for i in range(2, k + 2)}  # two data chunks lost
    assert port.decode_concat(avail)[:len(payload)] == payload


def test_decode_array_rebuilds_coding_from_recovered_data():
    port, ref = _pair("cauchy_good", 4, 2, 8)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (4, 8 * 37), dtype=np.uint8)
    coding = port.encode_array(data)
    assert np.array_equal(coding, np.asarray(ref.encode_array(data)))
    avail = {0: data[0], 2: data[2], 3: data[3], 4: coding[0]}
    out = port.decode_array(avail, [1, 5], data.shape[1])
    rout = ref.decode_array(avail, [1, 5], data.shape[1])
    assert np.array_equal(out[1], data[1])
    assert np.array_equal(out[5], coding[1])
    for i in (1, 5):
        assert np.array_equal(out[i], np.asarray(rout[i]))
    assert port.recovery_bits([0, 2, 3, 4]).tobytes() == \
        ref._decode_cache[(0, 2, 3, 4)].tobytes()


@pytest.mark.parametrize("profile", [
    {"technique": "liberation", "k": "4", "m": "2", "w": "8"},
    {"technique": "liberation", "k": "8", "m": "2", "w": "7"},
    {"technique": "liberation", "k": "4", "m": "3", "w": "7"},
    {"technique": "blaum_roth", "k": "4", "m": "2", "w": "8"},
    {"technique": "blaum_roth", "k": "4", "m": "3", "w": "6"},
    {"technique": "liber8tion", "k": "9", "m": "2"},
    {"technique": "liber8tion", "k": "4", "m": "1"},
    {"technique": "cauchy_good", "k": "1", "m": "1"},
])
def test_technique_errors_match_reference(profile):
    with pytest.raises(RefError):
        ref_instance().factory("jerasure", dict(profile))
    with pytest.raises(ErasureCodeError):
        instance().factory("jerasure", dict(profile), device="cpu")


def test_ragged_width_is_refused():
    port, _ = _pair("cauchy_good", 4, 2, 8)
    with pytest.raises(ErasureCodeError, match="multiple of w"):
        port.encode_array(np.zeros((4, 12), np.uint8))
