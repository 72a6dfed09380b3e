"""The port's GF(2^8) product (ceph_tpu_torch.ops.gf256) held bit for bit
against the reference package: the Pallas kernel in interpret mode
(ceph_tpu.ops.gf256_pallas.encode_planes, with a nonzero seed) and the
reference dispatcher ceph_tpu.ops.gf256_swar.gf_matmul_bytes.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ec.codec import RSMatrixCodec as RefCodec
from ceph_tpu.ops import gf256_pallas, gf256_swar
from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.codec import RSMatrixCodec
from ceph_tpu_torch.ops import gf256

SHAPES = [(8, 4), (4, 2), (3, 3)]
TILE = 8
PALLAS_N = 4 * gf256_pallas.LANES * TILE  # T = 8 sublane rows, one tile


def _planes(rng, k, n):
    return rng.integers(0, 256, size=(k, n), dtype=np.uint8)


def _port(matrix, x, **kw):
    return gf256.gf_matmul_bytes(matrix, torch.from_numpy(x), **kw).numpy()


@pytest.mark.parametrize("k,m", SHAPES)
@pytest.mark.parametrize("n", [1, 3, 4, 1001, 4096, 8192])
def test_matches_reference_dispatcher(k, m, n):
    rng = np.random.default_rng(1000 * k + n)
    for coding in (ref_matrices.isa_cauchy(k, m),
                   ref_matrices.isa_rs_vandermonde(k, m)):
        x = _planes(rng, k, n)
        want = np.asarray(gf256_swar.gf_matmul_bytes(coding, x))
        got = _port(coding, x)
        assert got.shape == (m, n)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k,m", SHAPES)
@pytest.mark.parametrize("seed", [0, 0xA5A5A5A5, 0x80000001])
def test_matches_pallas_kernel_interpret_with_seed(k, m, seed):
    import jax.numpy as jnp

    coding = ref_matrices.isa_cauchy(k, m)
    x = _planes(np.random.default_rng(k + seed % 97), k, PALLAS_N)
    out = gf256_pallas.encode_planes(
        coding, gf256_pallas.pack_planes(x),
        jnp.full((1,), seed, jnp.uint32), tile=TILE, interpret=True)
    want = gf256_pallas.unpack_planes(out)
    got = _port(coding, x, seed=seed)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("survivors", [
    [0, 1, 2, 3, 4, 5, 8, 9], [4, 5, 6, 7, 8, 9, 10, 11],
    [0, 2, 4, 6, 8, 9, 10, 11]])
def test_recovery_matrix_products_match(survivors):
    k, m = 8, 4
    coding = ref_matrices.isa_rs_vandermonde(k, m)
    ref = RefCodec(k, m, coding)
    port = RSMatrixCodec(k, m, coding, device="cpu")
    rec_ref, bits_ref = ref.recovery_matrix(survivors)
    rec, bits = port.recovery_matrix(survivors)
    assert np.array_equal(rec, rec_ref) and np.array_equal(bits, bits_ref)
    rng = np.random.default_rng(sum(survivors))
    data = _planes(rng, k, PALLAS_N)
    full = np.concatenate([data, np.asarray(
        gf256_swar.gf_matmul_bytes(coding, data))])
    surv = full[survivors]
    want = np.asarray(gf256_swar.gf_matmul_bytes(rec_ref, surv))
    assert np.array_equal(want, data)
    assert np.array_equal(_port(rec, surv), data)
    seed_ref = gf256_pallas.unpack_planes(gf256_pallas.encode_planes(
        rec_ref, gf256_pallas.pack_planes(surv[:, :PALLAS_N]), tile=TILE,
        interpret=True))
    assert np.array_equal(_port(rec, surv[:, :PALLAS_N]), seed_ref)


@pytest.mark.parametrize("n", [4096, 1001])
def test_donation_writes_in_place_when_square(n):
    coding = ref_matrices.isa_cauchy(3, 3)
    x = _planes(np.random.default_rng(5), 3, n)
    want = np.asarray(gf256_swar.gf_matmul_bytes(coding, x))
    t = torch.from_numpy(x.copy())
    got = gf256.gf_matmul_bytes(coding, t, donate=True)
    assert got.data_ptr() == t.data_ptr()
    assert np.array_equal(got.numpy(), want)
    # non-square: donation does not apply, the input stays
    c42 = ref_matrices.isa_cauchy(4, 2)
    x4 = _planes(np.random.default_rng(6), 4, n)
    t4 = torch.from_numpy(x4.copy())
    out = gf256.gf_matmul_bytes(c42, t4, donate=True)
    assert np.array_equal(t4.numpy(), x4)
    assert np.array_equal(out.numpy(),
                          np.asarray(gf256_swar.gf_matmul_bytes(c42, x4)))


def test_out_row_slice_of_a_batch():
    """The queue writes coding planes straight under the data planes."""
    k, m = 8, 4
    coding = matrices.isa_rs_vandermonde(k, m)
    full = torch.from_numpy(_planes(np.random.default_rng(7), k + m, 1024))
    ret = gf256.gf_matmul_bytes(coding, full[:k], out=full[k:])
    assert ret.data_ptr() == full[k:].data_ptr()
    want = np.asarray(gf256_swar.gf_matmul_bytes(
        ref_matrices.isa_rs_vandermonde(k, m), full[:k].numpy()))
    assert np.array_equal(full[k:].numpy(), want)


def test_wrapper_rejects_what_it_does_not_take():
    coding = matrices.isa_cauchy(4, 2)
    with pytest.raises(TypeError):
        gf256.gf_matmul_bytes(coding, np.zeros((4, 8), np.uint8))
    with pytest.raises(ValueError):
        gf256.gf_matmul_bytes(coding, torch.zeros((3, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf256.gf_matmul_bytes(coding, torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        gf256.gf_matmul_bytes(coding, torch.zeros((4, 8), dtype=torch.uint8),
                              out=torch.zeros((2, 9), dtype=torch.uint8))
    with pytest.raises(ValueError):  # neither cuda nor cpu: no detour
        gf256.gf_matmul_bytes(coding, torch.zeros(
            (4, 8), dtype=torch.uint8, device="meta"))


def test_cpu_path_launches_no_kernel():
    before = gf256.launches.value
    _port(matrices.isa_cauchy(4, 2), np.zeros((4, 64), np.uint8))
    assert gf256.launches.value == before


# -- K1's host side: the expanded operand and the network the kernel runs --

EDGES = [1, 4, 5, 8, 9, 16, 17, 32]  # the kernel's row and column buckets
OPERAND_SEEDS = [0, 0xA5A5A5A5]


def _ref_with_seed(mat, x, seed):
    """The reference product of x with ``seed`` XOR'd into every word."""
    words = np.ascontiguousarray(x).view(np.uint32) ^ np.uint32(seed)
    return np.asarray(gf256_swar.gf_matmul_bytes(mat, words.view(np.uint8)))


@pytest.mark.parametrize("R", EDGES)
@pytest.mark.parametrize("k", EDGES)
def test_operand_network_matches_swar_and_reference(R, k):
    rng = np.random.default_rng(100 * R + k)
    mat = rng.integers(0, 256, (R, k), dtype=np.uint8)
    mat[0, 0] = 0xFF  # every doubling of column 0 and row 0 is live
    x = _planes(rng, k, 64)
    cols = [c for c in torch.from_numpy(x).view(torch.int32)]
    op = gf256.k1_operand(mat)
    for seed in OPERAND_SEEDS:
        want = _ref_with_seed(mat, x, seed)
        for mul_shift in (False, True):
            got = torch.stack(gf256.operand_network(op, cols, seed,
                                                    mul_shift))
            swar = torch.stack(gf256.swar_network(mat, cols, seed,
                                                  mul_shift))
            assert torch.equal(got, swar)
            assert np.array_equal(got.contiguous().view(torch.uint8).numpy(),
                                  want)


@pytest.mark.parametrize("R,k,blocks", [
    (4, 8, [(0, 4)]), (8, 8, [(0, 8)]), (32, 16, [(0, 32)]),
    (16, 32, [(0, 16)]), (17, 17, [(0, 16), (16, 1)]),
    (32, 32, [(0, 16), (16, 16)]), (17, 32, [(0, 16), (16, 1)]),
    (32, 17, [(0, 16), (16, 16)])])
def test_operand_layout_buckets_and_row_blocks(R, k, blocks):
    rng = np.random.default_rng(R * k)
    mat = rng.integers(0, 256, (R, k), dtype=np.uint8)
    op = gf256.K1Operand(mat)
    assert [(r0, rows) for r0, rows, _ in op.blocks] == blocks
    for r0, rows, masks in op.blocks:
        assert masks.dtype == np.uint32
        assert masks.shape == (gf256.bucket(rows), 8, gf256.bucket(k))
        # parameter space: every block fits the kernel's 32,764 bytes
        assert masks.nbytes <= 16 * 32 * 32
        assert set(np.unique(masks)) <= {0, 0xFFFFFFFF}
        assert not masks[rows:].any() and not masks[:, :, k:].any()
        for i in range(rows):
            for j in range(k):
                bits = [(int(mat[r0 + i, j]) >> (7 - s)) & 1
                        for s in range(8)]
                assert list(masks[i, :, j] != 0) == [bool(b) for b in bits]


def test_operand_cache_returns_the_same_object_for_equal_matrices():
    mat = matrices.isa_rs_vandermonde(8, 4)
    op = gf256.k1_operand(mat)
    assert gf256.k1_operand(mat.copy()) is op
    assert gf256.k1_operand(mat.tolist()) is op
    assert gf256.k1_operand(mat.astype(np.uint32)) is op
    other = mat.copy()
    other[0, 0] ^= 1
    assert gf256.k1_operand(other) is not op
    # same bytes, other shape: another operand
    assert gf256.k1_operand(mat.reshape(8, 4)) is not op
    rec, _ = RSMatrixCodec(8, 4, mat, device="cpu").recovery_matrix(
        [0, 1, 2, 3, 4, 5, 8, 9])
    assert gf256.k1_operand(rec) is gf256.k1_operand(rec.copy())
    with pytest.raises(ValueError):
        gf256.k1_operand(np.zeros((33, 4), np.uint8))
