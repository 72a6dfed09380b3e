"""The port's GF(2) bit-matrix product (ceph_tpu_torch.ops.gf2_matmul)
held against ceph_tpu.ops.gf2_matmul on the CPU, bit for bit
(tolerance 0): the plain product against the jnp reference for several
(R, K) and ragged widths, the bit-plane helpers, prepare_bitmatrix, the
identity, the kernel's packed mask operand, and the batched packet entry
against the reference BitmatrixCodec.encode_array job by job."""

import sys
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ops import gf2_matmul as ref_gf2
from ceph_tpu_torch.ec import codec_from_profile, gf, matrices
from ceph_tpu_torch.ops import gf2_matmul


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("R,K", [(1, 1), (4, 8), (8, 8), (3, 24), (24, 8),
                                 (32, 64), (64, 64), (16, 49)])
@pytest.mark.parametrize("n", [1, 5, 127, 2048, 3001])
def test_plain_matches_reference(R, K, n):
    rng = np.random.default_rng(R * 1000 + K * 10 + n)
    mbits = rng.integers(0, 2, (8 * R, 8 * K), dtype=np.int8)
    x = _rand(n, (K, n))
    want = np.asarray(ref_gf2.gf2_matmul_bytes_ref(mbits, x))
    got = gf2_matmul.gf2_matmul_bytes(mbits, torch.from_numpy(x))
    assert got.dtype == torch.uint8 and got.shape == (R, n)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["contrib", "solve"])
@pytest.mark.parametrize("n", [1, 3, 17, 4099, 65537])
def test_plain_matches_reference_on_shec_operands(which, n):
    """shec k=8 m=4 c=3's two read operands ([24, 64] contribution and
    [24, 24] solve, data shards 0-2 lost) through the plain version equal
    ceph_tpu's gf2_matmul_bytes_ref at ragged widths, tolerance 0."""
    sh = codec_from_profile("plugin=shec k=8 m=4 c=3", device="cpu")
    _, s_op, c_op = sh.solve_operands((0, 1, 2), tuple(range(3, 12)))
    op = c_op if which == "contrib" else s_op
    assert op.mbits.shape == ((24, 64) if which == "contrib" else (24, 24))
    x = _rand(n + op.K, (op.K, n))
    want = np.asarray(ref_gf2.gf2_matmul_bytes_ref(op.mbits, x))
    got = gf2_matmul.gf2_matmul_bytes_plain(op, torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


def test_non_binary_entries_reduce_mod_two_like_the_reference():
    rng = np.random.default_rng(7)
    mbits = rng.integers(-128, 128, (32, 64), dtype=np.int8)
    x = _rand(8, (8, 300))
    want = np.asarray(ref_gf2.gf2_matmul_bytes_ref(mbits, x))
    got = gf2_matmul.gf2_matmul_bytes(mbits, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4), (10, 4)])
def test_prepare_bitmatrix_and_rs_product_match(k, m):
    coding = ref_matrices.isa_cauchy(k, m)
    mbits = gf2_matmul.prepare_bitmatrix(coding)
    want_bits = ref_gf2.prepare_bitmatrix(coding)
    assert mbits.dtype == want_bits.dtype == np.int8
    assert mbits.tobytes() == want_bits.tobytes()
    x = _rand(k * m, (k, 1000))
    got = gf2_matmul.gf2_matmul_bytes(mbits, torch.from_numpy(x)).numpy()
    want = np.zeros((m, 1000), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            want[i] ^= ref_gf.mul_bytes(int(coding[i, j]), x[j])
    assert np.array_equal(got, want)


def test_bitplane_helpers_match_reference():
    x = _rand(1, (5, 256))
    planes = gf2_matmul.bytes_to_bitplanes(torch.from_numpy(x))
    want = np.asarray(ref_gf2.bytes_to_bitplanes(x))
    assert planes.dtype == torch.int8
    assert np.array_equal(planes.numpy(), want)
    assert np.array_equal(gf.bytes_to_bitplanes(x), ref_gf.bytes_to_bitplanes(x))
    back = gf2_matmul.bitplanes_to_bytes(planes.to(torch.int32))
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(gf.bitplanes_to_bytes(want), x)


def test_identity_bitmatrix_is_noop():
    eye = gf2_matmul.prepare_bitmatrix(np.eye(4, dtype=np.uint32))
    x = torch.from_numpy(_rand(2, (4, 512)))
    assert torch.equal(gf2_matmul.gf2_matmul_bytes(eye, x), x)


@pytest.mark.parametrize("R,K", [(4, 8), (64, 64), (96, 96), (3, 5)])
def test_kernel_masks_hold_the_bitmatrix(R, K):
    """The kernel's operand: row r's bits, packed little-endian into kw
    u32 words, are row r of mbits mod 2, zero-padded to 32*kw columns,
    and lie in mma B-fragment order: lane 4g+t of step s for output row
    i holds words 8s+t and 8s+t+4 of row 8i+g."""
    rng = np.random.default_rng(R + K)
    mbits = rng.integers(-3, 4, (8 * R, 8 * K), dtype=np.int8)
    op = gf2_matmul.BitOperand(mbits)
    masks = op.masks(torch.device("cpu"))
    kw = op.kw
    assert masks.dtype == torch.int32
    assert masks.shape == (R, kw // 8, 32, 2)
    assert 4 * kw >= K and kw in gf2_matmul.KW_BUCKETS
    frags = masks.numpy().view(np.uint32)
    words = np.empty((8 * R, kw), dtype=np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for s in range(kw // 8):
            for h in range(2):
                words[g::8, 8 * s + 4 * h + t] = frags[:, s, lane, h]
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    assert np.array_equal(bits[:, :8 * K], mbits & 1)
    assert not bits[:, 8 * K:].any()
    assert op.masks(torch.device("cpu")) is masks  # cached per device


@pytest.mark.parametrize("K", [1, 3, 4, 5, 8, 16, 17, 32, 33, 64, 65, 128])
def test_one_hot_bit_lands_in_its_fragment_slot(K):
    """A matrix with one set entry (output bit 8i+b, input bit 8L+c) puts
    exactly one bit in the operand: lane 4b + (L%16)//4 of step L//32, for
    output row i, register (L%32)//16, bit 8*(L%4) + c.  The bucket is the
    least number of whole 256-bit steps that holds K rows."""
    R = 3
    kw = gf2_matmul.BitOperand(np.ones((8 * R, 8 * K), np.int8)).kw
    assert kw == 8 * (1 if K <= 32 else 2 if K <= 64 else 4)
    rng = np.random.default_rng(K)
    for _ in range(12):
        i, b = int(rng.integers(R)), int(rng.integers(8))
        L, c = int(rng.integers(K)), int(rng.integers(8))
        mbits = np.zeros((8 * R, 8 * K), np.int8)
        mbits[8 * i + b, 8 * L + c] = 1
        frags = gf2_matmul.BitOperand(mbits).masks(
            torch.device("cpu")).numpy().view(np.uint32)
        want = np.zeros_like(frags)
        want[i, L // 32, 4 * b + (L % 16) // 4, (L % 32) // 16] = \
            1 << (8 * (L % 4) + c)
        assert np.array_equal(frags, want)


def test_masks_are_built_once_under_concurrent_callers():
    """Decode threads share a codec's operands: however many ask at once,
    one mask tensor per device is built and every caller gets it."""
    op = gf2_matmul.BitOperand(
        np.random.default_rng(4).integers(0, 2, (512, 512), dtype=np.int8))
    got, barrier = [], threading.Barrier(16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            barrier.wait(timeout=30)
            got.append(op.masks(torch.device("cpu")))

        ths = [threading.Thread(target=worker) for _ in range(16)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 16 and all(t is got[0] for t in got)


def test_operand_limits_and_shape_errors():
    with pytest.raises(ValueError, match="K <= 128"):
        gf2_matmul.BitOperand(np.zeros((8, 8 * 129), np.int8)).kw
    with pytest.raises(ValueError):
        gf2_matmul.BitOperand(np.zeros((7, 8), np.int8))
    op = gf2_matmul.BitOperand(np.zeros((16, 32), np.int8))
    with pytest.raises(ValueError):
        gf2_matmul.gf2_matmul_bytes(op, torch.zeros((3, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        gf2_matmul.gf2_matmul_bytes(op, np.zeros((4, 8), np.uint8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gf2_matmul.gf2_matmul_bytes(
            op, torch.zeros((4, 8), dtype=torch.uint8, device="meta"))
    x = torch.zeros((4, 64), dtype=torch.uint8)
    out = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of w"):
        gf2_matmul.gf2_matmul_packets(op, x[:2], out[:1], [0], [31], 2)
    with pytest.raises(ValueError, match="inside"):
        gf2_matmul.gf2_matmul_packets(op, x, out, [40], [32], 1)


@pytest.mark.parametrize("widths", [[3072], [3072, 3072], [1536, 512, 4096],
                                    [8 * 3001, 8 * 517, 8 * 12347]])
def test_packet_batch_equals_reference_encode_per_job(widths):
    """Jobs side by side, with gaps, give per job exactly what the
    reference BitmatrixCodec.encode_array gives that job alone."""
    prof = "plugin=jerasure k=4 m=2 technique=cauchy_good"
    ref = ref_codec_from_profile(prof)
    mbits = gf2_matmul.prepare_bitmatrix(ref.coding_bits.astype(np.uint32))
    k, m, w = ref.k, ref.m, ref.w
    offs, o = [], 1
    for wd in widths:
        offs.append(o)
        o += wd + 3
    x = _rand(sum(widths), (k, o))
    out = torch.full((m, o), 0xAB, dtype=torch.uint8)
    got = gf2_matmul.gf2_matmul_packets(mbits, torch.from_numpy(x), out,
                                        offs, widths, w)
    assert got is out
    untouched = np.ones(o, bool)
    for off, wd in zip(offs, widths):
        want = np.asarray(ref.encode_array(x[:, off:off + wd]))
        assert np.array_equal(got[:, off:off + wd].numpy(), want)
        untouched[off:off + wd] = False
    assert (got.numpy()[:, untouched] == 0xAB).all()


def test_packet_entry_with_one_job_and_w_one_is_the_plain_product():
    rng = np.random.default_rng(9)
    mbits = rng.integers(0, 2, (24, 48), dtype=np.int8)
    x = torch.from_numpy(_rand(9, (6, 999)))
    out = torch.empty((3, 999), dtype=torch.uint8)
    gf2_matmul.gf2_matmul_packets(mbits, x, out, [0], [999], 1)
    assert torch.equal(out, gf2_matmul.gf2_matmul_bytes_plain(mbits, x))


@pytest.mark.parametrize("k,m,w", [(4, 2, 8), (6, 3, 8), (8, 4, 8), (5, 3, 4)])
def test_cauchy_matrices_byte_identical(k, m, w):
    for got, want in ((matrices.cauchy_original(k, m, w),
                       ref_matrices.cauchy_original(k, m, w)),
                      (matrices.cauchy_good(k, m, w),
                       ref_matrices.cauchy_good(k, m, w))):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert gf.matrix_to_bitmatrix(got, w).tobytes() == \
            ref_gf.matrix_to_bitmatrix(want, w).tobytes()


def test_gf_solve_matmul_div_pow_match_reference():
    rng = np.random.default_rng(11)
    A = rng.integers(1, 256, (5, 3)).astype(np.uint32)
    B = rng.integers(0, 256, (5, 2)).astype(np.uint32)
    assert np.array_equal(gf.matmul(A.T, B), ref_gf.matmul(A.T, B))
    a = np.arange(1, 256, dtype=np.uint32)
    assert np.array_equal(gf.div(a, a[::-1]), ref_gf.div(a, a[::-1]))
    for base, e in ((2, 0), (2, 7), (3, 200), (29, 13)):
        assert gf.pow_(base, e) == ref_gf.pow_(base, e)
    X = gf.solve(A, np.eye(5, dtype=np.uint32)[:, :3])
    assert np.array_equal(X, ref_gf.solve(A, np.eye(5, dtype=np.uint32)[:, :3]))
    with pytest.raises(ValueError):
        gf.solve(np.zeros((3, 2), np.uint32), np.zeros((3, 1), np.uint32))


# -- the packet-XOR path: structure detection and its plain version ---------

JERASURE_BITMATRIX = [
    "plugin=jerasure k=8 m=4 technique=cauchy_good",
    "plugin=jerasure k=5 m=3 technique=cauchy_orig w=4",
    "plugin=jerasure k=6 m=2 technique=blaum_roth w=6",
    "plugin=jerasure k=7 m=2 technique=liberation w=7",
    "plugin=jerasure k=8 m=2 technique=liber8tion",
]


@pytest.mark.parametrize("profile", JERASURE_BITMATRIX)
def test_every_jerasure_operand_is_a_packet_matrix(profile):
    """Encode and recovery operands of each bit-matrix technique have
    only zero or identity 8x8 blocks; the packet matrix is the codec's
    0/1 matrix and the CSR lists name its ones row by row."""
    codec = codec_from_profile(profile, device="cpu")
    k, m = codec.k, codec.m
    for M in (codec.coding_bits,
              codec.recovery_bits(list(range(k))),
              codec.recovery_bits(list(range(m, k + m))),
              codec.recovery_bits([0] + list(range(2, k + 1)))):
        op = codec.operand(M)
        assert op.packet is not None
        assert np.array_equal(op.packet, M & 1)
        for i in range(op.R):
            row = op.idx[op.rowptr[i]:op.rowptr[i + 1]]
            assert list(row) == list(np.nonzero(M[i])[0])
        assert op.rowptr[-1] == int(M.sum())


def test_shec_operands_and_random_bitmatrices_are_not_packet_matrices():
    sh = codec_from_profile("plugin=shec k=8 m=4 c=3", device="cpu")
    _, s_op, contrib_op = sh.solve_operands((0, 1, 2), tuple(range(3, 12)))
    assert s_op.packet is None and contrib_op.packet is None
    rng = np.random.default_rng(31)
    assert gf2_matmul.BitOperand(
        rng.integers(0, 2, (32, 64), dtype=np.int8)).packet is None
    # odd entries count as ones, as the product takes them mod 2
    eye3 = np.kron(np.eye(3, dtype=np.int8), np.eye(8, dtype=np.int8)) * 3
    assert np.array_equal(gf2_matmul.BitOperand(eye3).packet, np.eye(3))
    with pytest.raises(ValueError, match="packet"):
        gf2_matmul.gf2_xor_packets_plain(
            s_op, torch.zeros((3, 8), dtype=torch.uint8),
            torch.zeros((3, 8), dtype=torch.uint8), [0], [8], 1)


@pytest.mark.parametrize("profile", JERASURE_BITMATRIX[:4],
                         ids=["w4", "w6", "w7", "w8"])
@pytest.mark.parametrize("which", ["encode", "decode"])
def test_xor_plain_matches_the_reference_product(profile, which):
    """A 3-job batch of unequal widths at odd offsets through
    gf2_xor_packets_plain: equal to gf2_matmul_packets_plain and, job by
    job, to ceph_tpu's gf2_matmul_bytes (JAX on the CPU) on its packet
    rows; columns outside the jobs untouched."""
    codec = codec_from_profile(profile, device="cpu")
    k, m, w = codec.k, codec.m, codec.w
    if which == "encode":
        M, rout = codec.coding_bits, m
    else:
        M, rout = codec.recovery_bits(list(range(1, k + 1))), k
    op = codec.operand(M)
    widths = [w * 301, w * 17, w * 1234]
    offs = [3, 3 + widths[0] + 5, 3 + widths[0] + 5 + widths[1] + 1]
    P = offs[-1] + widths[-1] + 7
    rng = np.random.default_rng(w)
    x = torch.from_numpy(rng.integers(0, 256, (k, P), dtype=np.uint8))
    out = torch.from_numpy(rng.integers(0, 256, (rout, P), dtype=np.uint8))
    got = gf2_matmul.gf2_xor_packets_plain(op, x, out.clone(), offs,
                                           widths, w)
    want = gf2_matmul.gf2_matmul_packets_plain(op, x, out.clone(), offs,
                                               widths, w)
    assert torch.equal(got, want)
    untouched = np.ones(P, bool)
    for o, wd in zip(offs, widths):
        packets = x[:, o:o + wd].reshape(k * w, wd // w).numpy()
        ref = np.asarray(ref_gf2.gf2_matmul_bytes(op.mbits, packets))
        assert np.array_equal(got[:, o:o + wd].numpy(),
                              ref.reshape(rout, wd))
        untouched[o:o + wd] = False
    assert torch.equal(got[:, untouched], out[:, untouched])


def test_the_operand_structure_picks_the_path(monkeypatch):
    """On the CPU the wrapper runs the plain version of the kernel the
    operand's structure picks: XOR for a jerasure operand, the popcount
    definition for shec's; nothing else decides."""
    calls = []
    for name in ("gf2_xor_packets_plain", "gf2_matmul_packets_plain"):
        real = getattr(gf2_matmul, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(gf2_matmul, name, spy)
    cg = codec_from_profile(JERASURE_BITMATRIX[0], device="cpu")
    x = torch.from_numpy(_rand(5, (8, 8 * 64)))
    cg.encode_planes(x)
    sh = codec_from_profile("plugin=shec k=8 m=4 c=3", device="cpu")
    _, _, contrib_op = sh.solve_operands((0, 1, 2), tuple(range(3, 12)))
    gf2_matmul.gf2_matmul_bytes(contrib_op, x)
    assert calls == ["gf2_xor_packets_plain", "gf2_matmul_packets_plain"]
