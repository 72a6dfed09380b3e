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
