"""The port's batched CRC-32C (ceph_tpu_torch.ops.crc32c_device) held bit
for bit against ceph_tpu.ops.crc32c_device's functions of the same names
and the native oracle core.crc.crc32c: lengths 0..4096, ragged tails,
chained inits, unaligned rows and multi-job column offsets."""

import numpy as np
import pytest
import torch

from ceph_tpu.core.crc import crc32c as native_crc32c
from ceph_tpu.ops import crc32c_device as ref
from ceph_tpu_torch.ops import crc32c_device as port


def test_tables_match_reference():
    assert np.array_equal(port._TABLES, ref._TABLES)


def test_lanes_all_lengths_0_to_4096_with_chained_inits():
    rng = np.random.default_rng(11)
    R, C = 4097, 4096
    rows = rng.integers(0, 256, size=(R, C), dtype=np.uint8)
    lens = np.arange(R, dtype=np.int32)
    inits = rng.integers(0, 1 << 32, size=R, dtype=np.uint64).astype(
        np.uint32)
    want = ref.crc32c_lanes(rows, lens, inits)
    got = port.crc32c_lanes(torch.from_numpy(rows), lens, inits)
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)
    zero = port.crc32c_lanes(torch.from_numpy(rows), lens)
    assert np.array_equal(zero, ref.crc32c_lanes(rows, lens))


@pytest.mark.parametrize("shift", [1, 3, 7])
def test_lanes_on_unaligned_row_views(shift):
    rng = np.random.default_rng(12 + shift)
    rows = rng.integers(0, 256, size=(64, 1031), dtype=np.uint8)
    lens = rng.integers(0, 1031 - shift, size=64)
    view = torch.from_numpy(rows)[:, shift:]
    want = ref.crc32c_lanes(np.ascontiguousarray(rows[:, shift:]), lens)
    assert np.array_equal(port.crc32c_lanes(view, lens), want)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 65, 1000, 4095, 4096])
def test_dev_matches_reference_and_native(n):
    blob = np.random.default_rng(13).integers(0, 256, 4096, dtype=np.uint8)
    data = blob[:n].tobytes()
    got = port.crc32c_dev(data, device="cpu")
    assert got == ref.crc32c_dev(data) == native_crc32c(data)


@pytest.mark.parametrize("cut", [0, 1, 5, 8, 100, 2047, 4096])
def test_dev_chained(cut):
    data = np.random.default_rng(14).integers(
        0, 256, 4096, dtype=np.uint8).tobytes()
    c1 = port.crc32c_dev(data[:cut], device="cpu")
    assert c1 == ref.crc32c_dev(data[:cut])
    assert port.crc32c_dev(data[cut:], c1, device="cpu") == \
        ref.crc32c_dev(data[cut:], c1) == native_crc32c(data)


@pytest.mark.parametrize("jobs", [1, 3, 5])
def test_rows_multi_job_offsets(jobs):
    rng = np.random.default_rng(15 + jobs)
    S = 6
    lens = rng.integers(1, 700, size=jobs)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]) + 3
    P = int(offs[-1] + lens[-1] + 11)
    full = rng.integers(0, 256, size=(S, P), dtype=np.uint8)
    inits = rng.integers(0, 1 << 32, size=jobs, dtype=np.uint64).astype(
        np.uint32)
    want = ref.crc32c_rows(full, offs, lens, inits)
    got = port.crc32c_rows(torch.from_numpy(full), offs, lens, inits)
    assert got.shape == (jobs, S)
    assert np.array_equal(got, want)
    for j in range(jobs):
        for s in range(S):
            o, ln = int(offs[j]), int(lens[j])
            assert int(got[j, s]) == native_crc32c(
                full[s, o:o + ln].tobytes(), int(inits[j]))


def test_rows_empty_and_bad_extents():
    full = torch.zeros((4, 16), dtype=torch.uint8)
    assert port.crc32c_rows(full, [], []).shape == (0, 4)
    with pytest.raises(ValueError):
        port.crc32c_rows(full, [10], [8])
    with pytest.raises(ValueError):
        port.crc32c_lanes(full, [17, 0, 0, 0])
    with pytest.raises(TypeError):
        port.crc32c_lanes(np.zeros((1, 8), np.uint8), [8])


def test_cpu_path_launches_no_kernel():
    before = port.launches.value
    port.crc32c_dev(b"abc", device="cpu")
    assert port.launches.value == before


# -- the combine algebra the segment-parallel kernel rests on ---------------


@pytest.mark.parametrize("cut", [0, 1, 7, 8, 4095, 4096, 9999, 10000])
@pytest.mark.parametrize("init", [0, 1, 0xFFFFFFFF, 0x9E3779B9])
def test_combine_joins_split_buffers_like_the_native_crc(cut, init):
    data = np.random.default_rng(21).integers(
        0, 256, 10000, dtype=np.uint8).tobytes()
    a = native_crc32c(data[:cut], init)
    b = native_crc32c(data[cut:])
    assert port.crc32c_combine(a, b, len(data) - cut) == \
        native_crc32c(data, init)


def test_combine_on_int64_tensors_element_wise():
    rng = np.random.default_rng(22)
    data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    cuts = rng.integers(0, 3001, 16)
    inits = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
    a = torch.tensor([native_crc32c(data[:c], int(i))
                      for c, i in zip(cuts, inits)], dtype=torch.int64)
    b = torch.tensor([native_crc32c(data[c:]) for c in cuts],
                     dtype=torch.int64)
    got = port.crc32c_combine(a, b, torch.from_numpy(3000 - cuts))
    assert got.dtype == torch.int64
    assert got.tolist() == [native_crc32c(data, int(i)) for i in inits]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 255, 4096, 65537])
def test_zeros_advances_through_zero_bytes(n):
    """Z_n(s) is the value after n zero bytes: with s = init ^ ~0 it
    gives the CRC of n zero bytes chained from init."""
    for init in (0, 0xDEADBEEF):
        want = native_crc32c(bytes(n), init)
        assert port.crc32c_zeros(init ^ 0xFFFFFFFF, n) ^ 0xFFFFFFFF == want
        got = port.crc32c_zeros(torch.tensor([init ^ 0xFFFFFFFF]),
                                torch.tensor([n]))
        assert int(got[0]) ^ 0xFFFFFFFF == want


def test_zeros_is_linear_and_composes():
    rng = np.random.default_rng(23)
    s, t = (int(v) for v in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
    for n, m in ((1, 1), (5, 1000), (4096, 8192), (123457, 3)):
        assert port.crc32c_zeros(s ^ t, n) == \
            port.crc32c_zeros(s, n) ^ port.crc32c_zeros(t, n)
        assert port.crc32c_zeros(port.crc32c_zeros(s, n), m) == \
            port.crc32c_zeros(s, n + m)


def _segment_case(seg, rng):
    """Rows of length 0, 1, seg-1, seg, seg+1 and 3*seg+7 at odd column
    offsets of a 6-row batch, with nonzero inits."""
    lens = np.array([0, 1, seg - 1, seg, seg + 1, 3 * seg + 7])
    offs = np.cumsum(np.concatenate([[3], lens[:-1] + 5]))
    P = int(offs[-1] + lens[-1] + 9)
    full = rng.integers(0, 256, size=(6, P), dtype=np.uint8)
    inits = rng.integers(0, 1 << 32, size=len(lens),
                         dtype=np.uint64).astype(np.uint32)
    return full, offs, lens, inits


@pytest.mark.parametrize("seg", [8, 24, 4096])
def test_segmented_plain_matches_reference_at_segment_edges(seg):
    full, offs, lens, inits = _segment_case(seg, np.random.default_rng(seg))
    want = ref.crc32c_rows(full, offs, lens, inits)
    got = port.crc32c_rows_segmented_plain(torch.from_numpy(full), offs,
                                           lens, inits, seg)
    assert got.dtype == np.uint32 and got.shape == (len(lens), 6)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seg", [24, 4096])
def test_segmented_plain_on_a_two_job_twelve_shard_batch(seg):
    """The main batch's shape, cut to 64 KiB a row: 2 jobs x 12 shards."""
    rng = np.random.default_rng(24)
    width = 64 << 10
    full = rng.integers(0, 256, size=(12, 2 * width), dtype=np.uint8)
    offs, lens = [0, width], [width, width]
    inits = [0, 0x12345678]
    want = ref.crc32c_rows(full, offs, lens, inits)
    got = port.crc32c_rows_segmented_plain(torch.from_numpy(full), offs,
                                           lens, inits, seg)
    assert np.array_equal(got, want)
    assert np.array_equal(got, port.crc32c_rows(torch.from_numpy(full),
                                                offs, lens, inits))


def test_segmented_plain_refuses_an_empty_segment():
    with pytest.raises(ValueError):
        port.crc32c_rows_segmented_plain(
            torch.zeros((1, 8), dtype=torch.uint8), [0], [8], None, 0)
