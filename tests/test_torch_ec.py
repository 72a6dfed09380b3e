"""The port's erasure-code surface (ceph_tpu_torch.ec) held against
ceph_tpu.ec: byte-identical matrices, the same chunk sizes, the same
encode/decode/decode_concat bytes under every erasure pattern of up to
m chunks, and the same error paths.  The port runs on device="cpu"
(its plain PyTorch product)."""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import instance as ref_instance
from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu_torch.ec import (ErasureCodeError, codec_from_profile,
                               codec_from_reference, gf, instance,
                               matrices)

RS_PROFILES = [
    ("isa", {"technique": "reed_sol_van"}),
    ("isa", {"technique": "cauchy"}),
    ("jerasure", {"technique": "reed_sol_van"}),
    ("jerasure", {"technique": "reed_sol_r6_op"}),
]


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 4), (10, 4), (21, 4),
                                 (32, 3), (6, 6)])
def test_matrices_byte_identical(k, m):
    pairs = [(matrices.isa_rs_vandermonde(k, m),
              ref_matrices.isa_rs_vandermonde(k, m)),
             (matrices.isa_cauchy(k, m), ref_matrices.isa_cauchy(k, m)),
             (matrices.jerasure_rs_vandermonde(k, m),
              ref_matrices.jerasure_rs_vandermonde(k, m)),
             (matrices.jerasure_rs_r6(k), ref_matrices.jerasure_rs_r6(k))]
    for got, want in pairs:
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    coding = ref_matrices.isa_cauchy(k, m)
    full = matrices.full_generator(coding)
    assert full.tobytes() == ref_matrices.full_generator(coding).tobytes()
    surv = list(range(m, k + m))
    assert matrices.decode_matrix(full, surv).tobytes() == \
        ref_matrices.decode_matrix(full, surv).tobytes()
    assert gf.matrix_to_bitmatrix(coding).tobytes() == \
        ref_gf.matrix_to_bitmatrix(coding).tobytes()


def test_gf_tables_and_inverse_match():
    for w in (4, 8, 16):
        for a, b in zip(gf.tables(w), ref_gf.tables(w)):
            assert np.array_equal(a, b)
    a = np.arange(1, 256, dtype=np.uint32)
    assert np.array_equal(gf.inv(a), ref_gf.inv(a))
    assert np.array_equal(gf.mul(a, a[::-1]), ref_gf.mul(a, a[::-1]))


@pytest.mark.parametrize("plugin,extra", RS_PROFILES)
def test_chunk_size_agrees(plugin, extra):
    prof = dict(extra, k="4", m="2")
    port = instance().factory(plugin, prof, device="cpu")
    ref = ref_instance().factory(plugin, prof)
    for size in [0, 1, 31, 32, 127, 128, 4095, 4096, 1 << 20, 3_000_001]:
        assert port.get_chunk_size(size) == ref.get_chunk_size(size), size
    assert port.get_chunk_count() == ref.get_chunk_count()
    assert port.get_alignment() == ref.get_alignment()


@pytest.mark.parametrize("plugin,extra", RS_PROFILES)
def test_encode_decode_every_erasure_pattern(plugin, extra):
    k, m = 4, 2
    prof = dict(extra, k=str(k), m=str(m))
    port = instance().factory(plugin, prof, device="cpu")
    ref = ref_instance().factory(plugin, prof)
    assert port.profile == ref.profile
    n = k + m
    rng = np.random.default_rng(len(plugin) + len(extra["technique"]))
    payload = rng.integers(0, 256, 3001, dtype=np.uint8).tobytes()
    got = port.encode(range(n), payload)
    want = ref.encode(range(n), payload)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    for lost in itertools.chain.from_iterable(
            itertools.combinations(range(n), e) for e in range(m + 1)):
        avail = {i: got[i] for i in range(n) if i not in lost}
        dec = port.decode(range(n), avail)
        rdec = ref.decode(range(n), {i: want[i] for i in avail})
        for i in range(n):
            assert np.array_equal(dec[i], rdec[i]), (lost, i)
            assert np.array_equal(dec[i], got[i]), (lost, i)
        concat = port.decode_concat(avail)
        assert concat == ref.decode_concat({i: want[i] for i in avail})
        assert concat[:len(payload)] == payload
        assert port.minimum_to_decode(range(k), avail) == \
            ref.minimum_to_decode(range(k), avail)


def test_codec_from_reference_carries_the_coding_matrix():
    for prof in ("plugin=isa k=8 m=4 technique=reed_sol_van",
                 "plugin=isa k=6 m=3 technique=cauchy",
                 "plugin=jerasure k=5 m=3 technique=reed_sol_van"):
        ref = ref_codec_from_profile(prof)
        port = codec_from_reference(ref.k, ref.m, np.asarray(ref.coding),
                                    ref.profile, device="cpu")
        own = codec_from_profile(prof, device="cpu")
        assert own.coding.tobytes() == np.asarray(ref.coding).tobytes()
        assert port.coding.tobytes() == own.coding.tobytes()
        payload = bytes(range(256)) * 40
        a = port.encode(range(ref.k + ref.m), payload)
        b = ref.encode(range(ref.k + ref.m), payload)
        for i in a:
            assert np.array_equal(a[i], b[i])


@pytest.mark.parametrize("plugin,profile", [
    ("nope", {}),
    ("isa", {"k": "1", "m": "1"}),
    ("jerasure", {"k": "1", "m": "1"}),
    ("isa", {"k": "8", "m": "5"}),
    ("isa", {"k": "22", "m": "4"}),
    ("isa", {"k": "33", "m": "2"}),
    ("isa", {"k": "4", "m": "2", "technique": "bogus"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "bogus"}),
    ("jerasure", {"k": "4", "m": "3", "technique": "reed_sol_r6_op"}),
    ("jerasure", {"k": "4", "m": "2", "w": "16"}),
])
def test_error_paths_match_reference(plugin, profile):
    with pytest.raises(RefError):
        ref_instance().factory(plugin, dict(profile))
    with pytest.raises(ErasureCodeError):
        instance().factory(plugin, dict(profile), device="cpu")


def test_fewer_than_k_chunks_raises():
    port = codec_from_profile("plugin=isa k=4 m=2", device="cpu")
    ref = ref_codec_from_profile("plugin=isa k=4 m=2")
    chunks = port.encode(range(6), b"x" * 1000)
    avail = {i: chunks[i] for i in (0, 4, 5)}
    with pytest.raises(RefError):
        ref.decode_concat(avail)
    with pytest.raises(ErasureCodeError):
        port.decode_concat(avail)
    with pytest.raises(ErasureCodeError):
        port.minimum_to_decode(range(4), [0, 4, 5])


@pytest.mark.parametrize("plugin,technique", [
    ("jerasure", "cauchy_orig"), ("jerasure", "cauchy_good"),
    ("jerasure", "liberation"), ("jerasure", "blaum_roth"),
    ("jerasure", "liber8tion"), ("lrc", ""), ("shec", ""), ("clay", "")])
def test_not_yet_ported_techniques_name_the_later_slice(plugin, technique):
    prof = {"k": "4", "m": "2"}
    if technique:
        prof["technique"] = technique
    with pytest.raises(ErasureCodeError, match="not ported yet"):
        instance().factory(plugin, prof, device="cpu")


def test_chunk_mapping_remaps_decode_concat():
    prof = {"k": "2", "m": "1", "mapping": "_DD"}
    port = instance().factory("isa", prof, device="cpu")
    ref = ref_instance().factory("isa", prof)
    assert port.chunk_mapping == ref.chunk_mapping == [1, 2, 0]
    chunks = ref.encode(range(3), b"abcdefgh" * 10)
    assert port.decode_concat(chunks) == ref.decode_concat(chunks)
