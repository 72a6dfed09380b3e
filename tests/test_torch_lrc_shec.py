"""The port's lrc (layered, locally repairable) and shec (shingled) codecs
held against ceph_tpu.ec on the CPU, bit for bit, mirroring
tests/test_lrc_shec.py: kml layer generation, explicit layers, local
repair and minimum_to_decode; shec matrices, every erasure pattern up to
c, the k=8 m=4 c=3 decode with data shards 0, 1 and 2 lost (which runs
on the GF(2) bit-matrix product), and shec's local minimum."""

import itertools
import json

import numpy as np
import pytest

from ceph_tpu.ec import instance as ref_instance
from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu.ec.lrc import ErasureCodeLrc as RefLrc
from ceph_tpu.ec.shec import shec_coding_matrix as ref_shec_coding_matrix
from ceph_tpu_torch.ec import ErasureCodeError, codec_from_profile, instance
from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.shec import ErasureCodeShec, shec_coding_matrix


def _lrc_pair(profile):
    return (ErasureCodeLrc.create(dict(profile), device="cpu"),
            RefLrc.create(dict(profile)))


def _payload(seed, size):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k,m,l", [(4, 2, 3), (8, 4, 3), (6, 3, 3),
                                   (2, 2, 2)])
def test_lrc_kml_generation_matches_reference(k, m, l):
    profile = {"k": str(k), "m": str(m), "l": str(l)}
    port, ref = _lrc_pair(profile)
    assert port.profile == ref.profile
    assert port.profile["mapping"] == ref.profile["mapping"]
    assert json.loads(port.profile["layers"]) == \
        json.loads(ref.profile["layers"])
    assert port.get_chunk_count() == ref.get_chunk_count()
    assert port.get_data_chunk_count() == ref.get_data_chunk_count()
    assert port.chunk_mapping == ref.chunk_mapping
    assert [x.chunks_map for x in port.layers] == \
        [x.chunks_map for x in ref.layers]
    assert port.rule_steps == ref.rule_steps
    assert port.get_alignment() == ref.get_alignment()
    for size in (1, 4096, 1 << 20):
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)


def test_lrc_documented_profile():
    port, _ = _lrc_pair({"k": "4", "m": "2", "l": "3"})
    assert port.profile["mapping"] == "DD__DD__"
    assert len(port.layers) == 3  # 1 global + 2 local
    assert all(x.codec.device.type == "cpu" for x in port.layers)


def test_lrc_roundtrip_local_repair_and_minimum_match_reference():
    port, ref = _lrc_pair({"k": "4", "m": "2", "l": "3"})
    payload = _payload(0, 4096)
    n = port.get_chunk_count()
    got = port.encode(range(n), payload)
    want = ref.encode(range(n), payload)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    for e in range(n):
        avail = {i: c for i, c in got.items() if i != e}
        dec = port.decode(list(range(n)), avail)
        for i in range(n):
            assert np.array_equal(np.asarray(dec[i]), got[i]), (e, i)
        minimum = port._minimum_to_decode([e], list(avail))
        assert minimum == ref._minimum_to_decode([e], list(avail))
        assert len(minimum) <= 4, (e, minimum)  # local, not a global k
        assert port.minimum_to_decode([e], list(avail)) == \
            ref.minimum_to_decode([e], list(avail))
    for pair in [(0, 4), (1, 5), (2, 6), (0, 7)]:
        avail = {i: c for i, c in got.items() if i not in pair}
        dec = port.decode(list(range(n)), avail)
        for i in range(n):
            assert np.array_equal(np.asarray(dec[i]), got[i]), (pair, i)


def test_lrc_same_group_double_erasure_uses_global_layer():
    port, ref = _lrc_pair({"k": "4", "m": "2", "l": "3"})
    payload = _payload(5, 8192)
    got = port.encode(range(8), payload)
    for pair in [(0, 1), (0, 2), (1, 2), (4, 5), (5, 6), (4, 6)]:
        avail = {i: c for i, c in got.items() if i not in pair}
        dec = port.decode(list(range(8)), avail)
        rdec = ref.decode(list(range(8)), avail)
        for i in range(8):
            assert np.array_equal(np.asarray(dec[i]), got[i])
            assert np.array_equal(np.asarray(dec[i]), np.asarray(rdec[i]))
        assert port.decode_concat(avail)[:len(payload)] == payload
        assert port._minimum_to_decode(range(4), list(avail)) == \
            ref._minimum_to_decode(range(4), list(avail))


def test_lrc_explicit_layers():
    profile = {"mapping": "DD_", "layers": '[ [ "DDc", "" ] ]'}
    port, ref = _lrc_pair(profile)
    assert port.get_chunk_count() == ref.get_chunk_count() == 3
    assert port.get_data_chunk_count() == 2
    payload = b"0123456789abcdef" * 8
    chunks = port.encode(range(3), payload)
    rchunks = ref.encode(range(3), payload)
    for i in range(3):
        assert np.array_equal(chunks[i], rchunks[i])
    out = port.decode([0, 1, 2], {0: chunks[0], 2: chunks[2]})
    assert np.array_equal(out[1], chunks[1])


def test_lrc_explicit_layers_with_inner_plugin_profiles():
    layers = json.dumps([["DDDDc_", "plugin=isa technique=cauchy"],
                         ["DD___c", ""], ["__DDc_", "plugin=jerasure "
                                          "technique=cauchy_good"]])
    # the third layer shares chunk 4 with the first: both code it
    profile = {"mapping": "DDDD__", "layers": layers}
    with pytest.raises(RefError):
        RefLrc.create(dict(profile, layers="not json"))
    with pytest.raises(ErasureCodeError):
        ErasureCodeLrc.create(dict(profile, layers="not json"),
                              device="cpu")
    port, ref = _lrc_pair(profile)
    payload = _payload(8, 3000)
    got, want = port.encode(range(6), payload), ref.encode(range(6), payload)
    for i in range(6):
        assert np.array_equal(got[i], want[i]), i


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2", "l": "3"},
    # Ceph's documented low-level lrc profile (erasure-code-lrc.rst)
    {"mapping": "__DD__DD",
     "layers": '[ [ "_cDD_cDD", "" ], [ "cDDD____", "" ], '
               '[ "____cDDD", "" ] ]'}])
def test_lrc_encode_array_equals_reference_coding_chunks(profile):
    port, ref = _lrc_pair(profile)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    payload = _payload(11, 5000)
    planes, blocksize = port.encode_prepare(payload)
    coding = port.encode_array(planes)
    data_pos = [port.chunk_index(i) for i in range(k)]
    coding_pos = [c for c in range(n) if c not in data_pos]
    assert coding.dtype == np.uint8
    assert coding.shape == (n - k, blocksize)
    want = ref.encode(range(n), payload)
    for row, c in zip(coding, coding_pos):
        assert np.array_equal(row, np.asarray(want[c])), c
    with pytest.raises(ValueError):
        port.encode_array(planes[:-1])


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2"},              # l missing
    {"k": "4", "m": "2", "l": "5"},    # (k+m) % l
    {"k": "8", "m": "4", "l": "4"},    # (k+m)/l = 3 does not divide k
    {"mapping": "DD_"},                # layers missing
    {"mapping": "DD_", "layers": '[ [ "DD", "" ] ]'},  # map too short
    {"mapping": "DDD_", "layers": '[ [ "DD_c", "" ] ]'},  # chunk 2 uncovered
])
def test_lrc_profile_errors_match_reference(profile):
    with pytest.raises(RefError):
        RefLrc.create(dict(profile))
    with pytest.raises(ErasureCodeError):
        ErasureCodeLrc.create(dict(profile), device="cpu")


@pytest.mark.parametrize("k,m,c", [(4, 3, 2), (8, 4, 3), (8, 4, 2),
                                   (6, 4, 4), (5, 2, 1), (10, 6, 3)])
def test_shec_matrices_byte_identical(k, m, c):
    got, want = shec_coding_matrix(k, m, c), ref_shec_coding_matrix(k, m, c)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (got == 0).any() or c == m


def test_shec_roundtrip_single_and_double_match_reference():
    prof = {"k": "4", "m": "3", "c": "2", "w": "8"}
    port = instance().factory("shec", dict(prof), device="cpu")
    ref = ref_instance().factory("shec", dict(prof))
    assert isinstance(port, ErasureCodeShec) and port.profile == ref.profile
    payload = _payload(1, 3000)
    n = port.get_chunk_count()
    got = port.encode(range(n), payload)
    want = ref.encode(range(n), payload)
    for i in range(n):
        assert np.array_equal(got[i], want[i])
    for erased in itertools.chain(((e,) for e in range(n)),
                                  itertools.combinations(range(n), 2)):
        avail = {i: c for i, c in got.items() if i not in erased}
        dec = port.decode(list(range(n)), avail)
        rdec = ref.decode(list(range(n)), avail)
        for i in range(n):
            assert np.array_equal(np.asarray(dec[i]), got[i]), (erased, i)
            assert np.array_equal(np.asarray(dec[i]), np.asarray(rdec[i]))
        assert port._minimum_to_decode(range(4), list(avail)) == \
            ref._minimum_to_decode(range(4), list(avail))


@pytest.mark.parametrize("lost", [(0, 1, 2), (0, 5, 9), (3, 4, 11),
                                  (7, 8, 10)])
def test_shec_documented_profile_decodes_three_losses(lost):
    """plugin=shec k=8 m=4 c=3 (Ceph's documented example): any three
    losses decode; with data shards lost the solve runs on the GF(2)
    product."""
    prof = "plugin=shec k=8 m=4 c=3"
    port = codec_from_profile(prof, device="cpu")
    ref = ref_instance().factory("shec", {"k": "8", "m": "4", "c": "3"})
    payload = _payload(sum(lost), 64 << 10)
    got = port.encode(range(12), payload)
    avail = {i: c for i, c in got.items() if i not in lost}
    dec = port.decode(list(range(12)), avail)
    rdec = ref.decode(list(range(12)), avail)
    for i in range(12):
        assert np.array_equal(np.asarray(dec[i]), got[i]), i
        assert np.array_equal(np.asarray(dec[i]), np.asarray(rdec[i]))
    assert port.decode_concat(avail)[:len(payload)] == payload
    assert port._minimum_to_decode(list(lost), list(avail)) == \
        ref._minimum_to_decode(list(lost), list(avail))


def test_shec_solve_operands_match_reference_bitmatrices():
    from ceph_tpu.ops import gf2_matmul as ref_gf2
    from ceph_tpu.ec import gf as ref_gf

    port = codec_from_profile("plugin=shec k=8 m=4 c=3", device="cpu")
    ref = ref_instance().factory("shec", {"k": "8", "m": "4", "c": "3"})
    erased, avail = (0, 1, 2), tuple(range(3, 12))
    parity_ids, s_op, contrib_op = port.solve_operands(erased, avail)
    assert parity_ids == ref._recovery_plan(erased, avail)[0]
    rows = np.stack([ref.coding[p - 8] for p in parity_ids])
    want_s = ref_gf2.prepare_bitmatrix(ref_gf.solve(
        rows[:, list(erased)], np.eye(len(parity_ids), dtype=np.uint32), 8))
    known = rows.copy()
    known[:, list(erased)] = 0
    assert s_op.mbits.tobytes() == want_s.tobytes()
    assert contrib_op.mbits.tobytes() == \
        ref_gf2.prepare_bitmatrix(known).tobytes()
    assert s_op.mbits.shape == (24, 24) and contrib_op.mbits.shape == (24, 64)


def test_shec_minimum_is_local():
    prof = {"k": "8", "m": "4", "c": "2", "w": "8"}
    port = instance().factory("shec", dict(prof), device="cpu")
    ref = ref_instance().factory("shec", dict(prof))
    sizes = []
    for e in range(8):
        avail = [i for i in range(12) if i != e]
        minimum = port._minimum_to_decode([e], avail)
        assert minimum == ref._minimum_to_decode([e], avail)
        sizes.append(len(minimum))
    assert min(sizes) < 8, sizes


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "3", "c": "4"}, {"k": "4", "m": "3", "c": "0"},
    {"k": "4", "m": "3", "c": "2", "w": "16"}])
def test_shec_profile_errors_match_reference(profile):
    with pytest.raises(RefError):
        ref_instance().factory("shec", dict(profile))
    with pytest.raises(ErasureCodeError):
        instance().factory("shec", dict(profile), device="cpu")
