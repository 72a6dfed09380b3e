"""The port's planes products (ceph_tpu_torch.ops.gf256_planes) held bit
for bit against the reference package's Pallas kernels in interpret mode
(ceph_tpu.ops.gf256_pallas.encode_planes and
encode_planes_interleaved), as tests/test_gf256_pallas.py runs them.

On the CPU the port's entries run their plain PyTorch versions; the CUDA
kernels (K1's planes entry, K2) are held against those same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
Tolerance: none, every word equal."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu._native import rs_encode
from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ec.codec import RSMatrixCodec as RefCodec
from ceph_tpu.ops import gf256_pallas, gf256_swar
from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.ops import gf256_planes as gp

SHAPES = [(8, 4), (4, 2), (3, 3)]
SEEDS = [0, 0xA5A5A5A5, 0x80000001]
TILE = 4
T = 8  # two tiles


def _bytes(rng, k, T=T):
    return rng.integers(0, 256, size=(k, T * 4 * gp.LANES), dtype=np.uint8)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inter(words: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(words, (1, 0, 2)))


def _ref_seed(seed):
    return jnp.full((1,), seed, jnp.uint32)


@pytest.mark.parametrize("k,m", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mul_shift", [False, True])
def test_interleaved_matches_pallas_interpret(k, m, seed, mul_shift):
    coding = ref_matrices.isa_cauchy(k, m)
    x = _bytes(np.random.default_rng(31 * k + seed % 89), k)
    words = _inter(gf256_pallas.pack_planes(x))
    want = np.asarray(gf256_pallas.encode_planes_interleaved(
        coding, words, _ref_seed(seed), tile=TILE, interpret=True,
        mul_shift=mul_shift))
    got = gp.encode_planes_interleaved(coding, _t(words), seed, tile=TILE,
                                       mul_shift=mul_shift)
    assert got.shape == (T, m, gp.LANES) and got.dtype == torch.int32
    assert np.array_equal(_u32(got), want)


# K2's row and column buckets (those of K1's operand, gf256.bucket): the
# edges of each bucket, 17 x 17 and 32 x 32 split into row blocks of 16
EDGES = [1, 4, 5, 8, 9, 16, 17, 32]
EDGE_PAIRS = [(1, 1), (4, 8), (8, 4), (5, 5), (9, 9), (16, 16), (17, 17),
              (32, 32), (1, 32), (32, 1), (17, 5), (5, 17)]


def _edge_case(R, k, T=T):
    """A random R x k matrix with every doubling live, interleaved words
    [T, k, 128] and a nonzero seed, all from one numpy seed."""
    rng = np.random.default_rng(1000 * R + k)
    mat = rng.integers(0, 256, (R, k), dtype=np.uint8)
    mat[0, 0] = 0xFF
    words = rng.integers(0, 1 << 32, (T, k, gp.LANES), dtype=np.uint32)
    seed = (0xA5A5A5A5, 0x80000001)[(R + k) % 2]
    return mat, words, seed


def _ref_interleaved(mat, words, seed):
    """The reference dispatcher's product of interleaved words with
    ``seed`` XOR'd into each: planar bytes through gf256_swar, back to
    [T, R, 128] words."""
    planar = _inter(words ^ np.uint32(seed))
    x = np.ascontiguousarray(planar).view(np.uint8).reshape(planar.shape[0],
                                                            -1)
    out = np.asarray(gf256_swar.gf_matmul_bytes(mat, x))
    return _inter(np.ascontiguousarray(out).view(np.uint32).reshape(
        mat.shape[0], words.shape[0], gp.LANES))


@pytest.mark.parametrize("R,k", EDGE_PAIRS)
def test_interleaved_bucket_edges_match_pallas_interpret(R, k):
    mat, words, seed = _edge_case(R, k)
    mul_shift = bool(R % 2)
    want = np.asarray(gf256_pallas.encode_planes_interleaved(
        mat, words, _ref_seed(seed), tile=T, interpret=True,
        mul_shift=mul_shift))
    got = gp.encode_planes_interleaved(mat, _t(words), seed, tile=T,
                                       mul_shift=mul_shift)
    assert got.shape == (T, R, gp.LANES)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("R", EDGES)
@pytest.mark.parametrize("k", EDGES)
def test_interleaved_bucket_edges_match_reference(R, k):
    mat, words, seed = _edge_case(R, k)
    want = _ref_interleaved(mat, words, seed)
    for mul_shift in (False, True):
        got = gp.encode_planes_interleaved(mat, _t(words), seed, tile=4,
                                           mul_shift=mul_shift)
        assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("R,k", [(32, 32), (17, 17), (32, 16), (8, 4)])
def test_operand_row_blocks_over_interleaved_columns_match_reference(R, k):
    """K2's split as the kernel takes it: each row block of K1's operand,
    applied by ``operand_network`` over the interleaved columns
    w[:, j, :] and written to its rows of every T-row, gives the
    reference's bytes (17 x 17 and 32 x 32 are two blocks)."""
    mat, words, seed = _edge_case(R, k)
    op = gf256.k1_operand(mat)
    assert len(op.blocks) == (2 if R > 16 and k > 16 else 1)
    w = _t(words)
    cols = [w[:, j, :] for j in range(k)]
    want = _ref_interleaved(mat, words, seed)
    for mul_shift in (False, True):
        out = torch.zeros((T, R, gp.LANES), dtype=torch.int32)
        for r0, rows, masks in op.blocks:
            block = SimpleNamespace(k=op.k, blocks=[(r0, rows, masks)])
            res = gf256.operand_network(block, cols, seed, mul_shift)
            assert len(res) == rows
            out[:, r0:r0 + rows, :] = torch.stack(res, dim=1)
        assert np.array_equal(_u32(out), want)


@pytest.mark.parametrize("k,m", SHAPES)
@pytest.mark.parametrize("mul_shift", [False, True])
def test_planar_matches_pallas_interpret(k, m, mul_shift):
    coding = ref_matrices.isa_cauchy(k, m)
    seed = 0xA5A5A5A5
    x = _bytes(np.random.default_rng(41 * k), k)
    words = gf256_pallas.pack_planes(x)
    want = np.asarray(gf256_pallas.encode_planes(
        coding, words, _ref_seed(seed), tile=TILE, interpret=True,
        mul_shift=mul_shift))
    got = gp.encode_planes(coding, _t(words), seed, tile=TILE,
                           mul_shift=mul_shift)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("interleaved", [False, True])
def test_recovery_matrix_decode_matches_pallas(interleaved):
    k, m = 8, 4
    coding = ref_matrices.isa_cauchy(k, m)
    x = _bytes(np.random.default_rng(9), k)
    coded = rs_encode(coding.astype(np.uint8), x)
    survivors = [0, 2, 3, 5, 6, 7, 8, 11]  # lose 1, 4 + coding 9, 10
    rec, _ = RefCodec(k, m, coding).recovery_matrix(survivors)
    surv = np.stack([x[s] if s < k else coded[s - k] for s in survivors])
    words = gf256_pallas.pack_planes(surv)
    if interleaved:
        words = _inter(words)
        want = np.asarray(gf256_pallas.encode_planes_interleaved(
            rec, words, tile=TILE, interpret=True))
        got = _u32(gp.encode_planes_interleaved(rec, _t(words), tile=TILE))
        got_bytes = _inter(got)
    else:
        want = np.asarray(gf256_pallas.encode_planes(rec, words, tile=TILE,
                                                     interpret=True))
        got = _u32(gp.encode_planes(rec, _t(words), tile=TILE))
        got_bytes = got
    assert np.array_equal(got, want)
    assert np.array_equal(gf256_pallas.unpack_planes(got_bytes), x)


@pytest.mark.parametrize("k,m", SHAPES)
def test_planar_and_interleaved_agree_through_a_transpose(k, m):
    coding = matrices.isa_cauchy(k, m)
    words = _t(gf256_pallas.pack_planes(
        _bytes(np.random.default_rng(k), k, T=16)))
    planar = gp.encode_planes(coding, words, 0x1234, tile=8)
    inter = gp.encode_planes_interleaved(
        coding, words.transpose(0, 1).contiguous(), 0x1234, tile=8)
    assert torch.equal(inter.transpose(0, 1), planar)
    seeded = gp.unpack_planes(words ^ 0x1234).numpy()
    assert np.array_equal(gp.unpack_planes(planar).numpy(),
                          rs_encode(coding.astype(np.uint8), seeded))


def test_pack_unpack_round_trip_equals_reference():
    x = _bytes(np.random.default_rng(5), 6, T=3)
    got = gp.pack_planes(torch.from_numpy(x))
    assert got.shape == (6, 3, gp.LANES) and got.dtype == torch.int32
    assert np.array_equal(_u32(got), gf256_pallas.pack_planes(x))
    assert np.array_equal(gp.unpack_planes(got).numpy(), x)
    with pytest.raises(ValueError, match="multiple of 512"):
        gp.pack_planes(torch.zeros((2, 500), dtype=torch.uint8))


@pytest.mark.parametrize("mul_shift", [False, True])
def test_plain_versions_give_the_same_bytes_for_both_doublings(mul_shift):
    coding = matrices.isa_cauchy(8, 4)
    words = _t(gf256_pallas.pack_planes(
        _bytes(np.random.default_rng(77), 8)))
    base = gp.encode_planes_plain(coding, words, 99)
    assert torch.equal(gp.encode_planes_plain(coding, words, 99, mul_shift),
                       base)
    inter = words.transpose(0, 1).contiguous()
    assert torch.equal(gp.encode_planes_interleaved_plain(
        coding, inter, 99, mul_shift).transpose(0, 1), base)


def test_tile_must_divide_T():
    coding = matrices.isa_cauchy(4, 2)
    words = torch.zeros((4, 12, gp.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of tile"):
        gp.encode_planes(coding, words, tile=8)
    with pytest.raises(ValueError, match="multiple of tile"):
        gp.encode_planes_interleaved(coding, words.transpose(0, 1), tile=8)
    with pytest.raises(ValueError, match="input rows"):
        gp.encode_planes(coding, words[:3], tile=4)
    with pytest.raises(ValueError, match="int32"):
        gp.encode_planes(coding, words.float(), tile=4)


def test_donate_writes_over_the_input_only_for_a_square_planar_code():
    rec, _ = RefCodec(8, 4, ref_matrices.isa_cauchy(8, 4)).recovery_matrix(
        [0, 1, 2, 3, 4, 5, 8, 9])
    words = _t(gf256_pallas.pack_planes(_bytes(np.random.default_rng(3), 8)))
    want = gp.encode_planes_plain(rec, words)
    got = gp.encode_planes(rec, words, tile=TILE, donate=True)
    assert got.data_ptr() == words.data_ptr() and torch.equal(got, want)
    x = _t(gf256_pallas.pack_planes(_bytes(np.random.default_rng(4), 8)))
    coded = gp.encode_planes(ref_matrices.isa_cauchy(8, 4), x, tile=TILE,
                             donate=True)
    assert coded.shape == (4, T, gp.LANES)
    assert coded.data_ptr() != x.data_ptr()


def test_out_is_written_and_checked():
    coding = matrices.isa_cauchy(8, 4)
    words = _t(_inter(gf256_pallas.pack_planes(
        _bytes(np.random.default_rng(6), 8))))
    out = torch.empty((T, 4, gp.LANES), dtype=torch.int32)
    got = gp.encode_planes_interleaved(coding, words, 5, tile=TILE, out=out)
    assert got is out
    assert torch.equal(out, gp.encode_planes_interleaved_plain(coding,
                                                               words, 5))
    with pytest.raises(ValueError, match="out must be"):
        gp.encode_planes_interleaved(coding, words, tile=TILE,
                                     out=torch.empty((T, 3, gp.LANES),
                                                     dtype=torch.int32))


def test_other_devices_raise():
    coding = matrices.isa_cauchy(4, 2)
    words = torch.zeros((8, 4, gp.LANES), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gp.encode_planes_interleaved(coding, words, tile=4)
