"""The port's stripe geometry (``ceph_tpu_torch/osd/ecutil.py``), case for
case against ``tests/test_ecutil.py``, and its offset algebra held to
``ceph_tpu.osd.ecutil`` over a seeded grid of geometries and offsets.
The port raises ``ValueError`` where the reference asserts."""

import numpy as np
import pytest

from ceph_tpu.osd.ecutil import StripeInfo as RefStripeInfo
from ceph_tpu_torch.osd.ecutil import StripeInfo


@pytest.fixture
def si():
    return StripeInfo(k=4, chunk_size=1024)  # stripe_width 4096


def test_stripe_bounds(si):
    assert si.stripe_width == 4096
    assert si.logical_to_prev_stripe_offset(0) == 0
    assert si.logical_to_prev_stripe_offset(4095) == 0
    assert si.logical_to_prev_stripe_offset(4096) == 4096
    assert si.logical_to_next_stripe_offset(1) == 4096
    assert si.logical_to_next_stripe_offset(4096) == 4096
    assert si.offset_len_to_stripe_bounds(5000, 100) == (4096, 4096)
    assert si.offset_len_to_stripe_bounds(4000, 200) == (0, 8192)


def test_chunk_offsets(si):
    assert si.logical_to_prev_chunk_offset(8191) == 1024
    assert si.logical_to_next_chunk_offset(8193) == 3072
    assert si.aligned_logical_offset_to_chunk_offset(8192) == 2048
    assert si.aligned_chunk_offset_to_logical_offset(2048) == 8192
    with pytest.raises(ValueError):
        si.aligned_logical_offset_to_chunk_offset(100)
    with pytest.raises(ValueError):
        si.aligned_chunk_offset_to_logical_offset(100)
    for off in (0, 4096, 40960):
        assert si.aligned_chunk_offset_to_logical_offset(
            si.aligned_logical_offset_to_chunk_offset(off)) == off
    assert si.aligned_offset_len_to_chunk(8192, 12288) == (2048, 3072)


def test_stripe_range_and_extent(si):
    assert si.stripe_range(0, 1) == (0, 1)
    assert si.stripe_range(4095, 2) == (0, 2)
    assert si.stripe_range(8192, 4096) == (2, 3)
    assert si.stripe_range(100, 0) == (0, 0)
    assert si.chunk_extent(2, 5) == (2048, 3072)
    assert si.object_stripes(0) == 1
    assert si.object_stripes(4097) == 2


def test_interleave_roundtrip(si):
    rng = np.random.default_rng(0)
    for size in (1, 4096, 5000, 65536):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        planes, S = si.interleave(data)
        assert planes.shape == (4, S * 1024)
        assert si.deinterleave(planes, size) == data


def test_interleave_placement_matches_layout_contract(si):
    """Logical bytes [s*width + j*unit, ...) live at chunk offset s*unit
    of shard j."""
    data = bytes(range(256)) * 32  # 8192 bytes = 2 stripes
    planes, S = si.interleave(data)
    assert S == 2
    for s in range(2):
        for j in range(4):
            logical = data[s * 4096 + j * 1024: s * 4096 + (j + 1) * 1024]
            assert planes[j, s * 1024: (s + 1) * 1024].tobytes() == logical


@pytest.mark.parametrize("k,chunk", [(4, 1024), (8, 4096), (3, 96), (1, 7)])
def test_offset_algebra_equals_the_reference(k, chunk):
    """Every method, the four new ones included, on a seeded grid of
    offsets and lengths (aligned and not), equals ``ceph_tpu``'s."""
    port, ref = StripeInfo(k, chunk), RefStripeInfo(k, chunk)
    rng = np.random.default_rng(k * 1000 + chunk)
    width = k * chunk
    offs = [0, 1, chunk, width - 1, width, 3 * width + 5] + [
        int(x) for x in rng.integers(0, 64 * width, 40)]
    lens = [0, 1, chunk, width, 2 * width + 3] + [
        int(x) for x in rng.integers(0, 8 * width, 10)]
    for off in offs:
        for name in ("logical_to_prev_stripe_offset",
                     "logical_to_next_stripe_offset",
                     "logical_to_prev_chunk_offset",
                     "logical_to_next_chunk_offset"):
            assert getattr(port, name)(off) == getattr(ref, name)(off)
        for length in lens:
            assert port.stripe_range(off, length) == \
                ref.stripe_range(off, length)
            assert port.offset_len_to_stripe_bounds(off, length) == \
                ref.offset_len_to_stripe_bounds(off, length)
        aligned = off - off % width
        assert port.aligned_logical_offset_to_chunk_offset(aligned) == \
            ref.aligned_logical_offset_to_chunk_offset(aligned)
        c_aligned = off - off % chunk
        assert port.aligned_chunk_offset_to_logical_offset(c_aligned) == \
            ref.aligned_chunk_offset_to_logical_offset(c_aligned)
        length = lens[-1] - lens[-1] % width
        assert port.aligned_offset_len_to_chunk(aligned, length) == \
            ref.aligned_offset_len_to_chunk(aligned, length)
        if off % width:
            with pytest.raises(ValueError):
                port.aligned_logical_offset_to_chunk_offset(off)
            with pytest.raises(AssertionError):
                ref.aligned_logical_offset_to_chunk_offset(off)
