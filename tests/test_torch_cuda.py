"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a CUDA device every test here skips
(the decision is taken inside the fixture, never at import).  Run them
on a GPU machine, where JAX (which tests/conftest.py imports) may be
absent, with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.crush import mapper, samples
from ceph_tpu_torch.ec import codec_from_profile, matrices
from ceph_tpu_torch.gpu.meshio import MeshCompute
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.ops import crc32c_device as cd
from ceph_tpu_torch.ops import benchloop, crush_rule, gf2_matmul, gf256
from ceph_tpu_torch.ops import gf256_planes, mesh_digest
from ceph_tpu_torch.osd.ecutil import StripeInfo
from ceph_tpu_torch.tools import ecbench

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (3, 3)])
@pytest.mark.parametrize("n", [1, 1001, 4096, 1 << 20])
def test_gf256_kernel_equals_plain(dev, k, m, n):
    coding = matrices.isa_rs_vandermonde(k, m)
    g = torch.Generator(device=dev).manual_seed(k * n)
    x = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                      generator=g)
    before = gf256.launches.value
    got = gf256.gf_matmul_bytes(coding, x, seed=0x5A5A5A5A)
    assert gf256.launches.value == before + 1
    assert torch.equal(got, gf256.gf_matmul_bytes_plain(coding, x,
                                                        seed=0x5A5A5A5A))


def test_gf256_kernel_donates_in_place(dev):
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    rec, _ = codec.recovery_matrix([0, 1, 2, 3, 4, 5, 8, 9])
    x = torch.randint(0, 256, (8, 1 << 16), dtype=torch.uint8, device=dev)
    want = gf256.gf_matmul_bytes_plain(rec, x)
    got = gf256.gf_matmul_bytes(rec, x, donate=True)
    assert got.data_ptr() == x.data_ptr() and torch.equal(got, want)


K1_EDGES = [1, 4, 5, 8, 9, 16, 17, 32]


@pytest.mark.parametrize("R", K1_EDGES)
@pytest.mark.parametrize("k", K1_EDGES)
def test_gf256_kernel_bucket_edges_both_alignments(dev, R, k):
    """A random R x k matrix at every bucket edge: 16-byte-aligned rows, a
    4-byte-aligned row slice and a ragged width (word-padded copy), both
    seeds and both doubling variants; a matrix past 16 x 16 launches once
    per row block, and the count says so."""
    rng = np.random.default_rng(R * 64 + k)
    mat = rng.integers(0, 256, (R, k), dtype=np.uint8)
    g = torch.Generator(device=dev).manual_seed(R * 64 + k)
    base = torch.randint(0, 256, (k, 4 * 5003 + 16), dtype=torch.uint8,
                         device=dev, generator=g)
    nl = len(gf256.k1_operand(mat).blocks)
    assert nl == (2 if R > 16 and k > 16 else 1)
    for x in (base[:, :4 * 5000], base[:, 4:4 + 4 * 5003],
              base[:, 1:1 + 4099]):
        for seed, shift in ((0, False), (0xA5A5A5A5, True)):
            before = gf256.launches.value
            got = gf256.gf_matmul_bytes(mat, x, seed=seed, mul_shift=shift)
            assert gf256.launches.value == before + nl
            assert torch.equal(got, gf256.gf_matmul_bytes_plain(
                mat, x, seed=seed))


@pytest.mark.parametrize("d", [8, 17, 32])
@pytest.mark.parametrize("n", [1 << 16, 4 * 4099, 4099])
def test_gf256_kernel_donates_at_every_split(dev, d, n):
    mat = np.random.default_rng(d).integers(0, 256, (d, d), dtype=np.uint8)
    x = torch.randint(0, 256, (d, n), dtype=torch.uint8, device=dev)
    want = gf256.gf_matmul_bytes_plain(mat, x, seed=9)
    ptr = x.data_ptr()
    got = gf256.gf_matmul_bytes(mat, x, donate=True, seed=9)
    assert got.data_ptr() == ptr and torch.equal(got, want)


@pytest.mark.parametrize("R,k", [(4, 8), (8, 8), (2, 17), (17, 17)])
@pytest.mark.parametrize("n", [1 << 16, 4 * 4099])
def test_gf256_kernel_into_out_row_slices(dev, R, k, n):
    """The queue's layout: the product written into the rows below its
    input in one batch (16-byte-aligned rows when n is, else 4-byte)."""
    mat = np.random.default_rng(R + k).integers(0, 256, (R, k),
                                                dtype=np.uint8)
    full = torch.randint(0, 256, (k + R, n), dtype=torch.uint8, device=dev)
    want = gf256.gf_matmul_bytes_plain(mat, full[:k])
    ret = gf256.gf_matmul_bytes(mat, full[:k], out=full[k:])
    assert ret.data_ptr() == full[k:].data_ptr()
    assert torch.equal(full[k:], want)


@pytest.mark.parametrize("profile", [
    "plugin=jerasure k=8 m=4 technique=cauchy_good",
    "plugin=jerasure k=7 m=2 technique=liberation w=7",
    "plugin=jerasure k=6 m=2 technique=blaum_roth w=10"])
@pytest.mark.parametrize("n", [1, 1001, 4096, 1 << 20])
def test_gf2_kernel_equals_plain(dev, profile, n):
    codec = codec_from_profile(profile, device=dev)
    K = codec.k * codec.w
    g = torch.Generator(device=dev).manual_seed(K * n)
    x = torch.randint(0, 256, (K, n), dtype=torch.uint8, device=dev,
                      generator=g)
    for M in (codec.coding_bits,
              codec.recovery_bits(list(range(2, codec.k + 2)))):
        op = codec.operand(M)
        before = (gf2_matmul.xor_launches.value, gf2_matmul.launches.value)
        got = gf2_matmul.gf2_matmul_bytes(op, x)
        # a jerasure operand is a 0/1 packet matrix: the XOR kernel runs
        assert (gf2_matmul.xor_launches.value,
                gf2_matmul.launches.value) == (before[0] + 1, before[1])
        assert torch.equal(got, gf2_matmul.gf2_matmul_bytes_plain(op, x))


def test_gf2_packet_batch_equals_plain(dev):
    codec = codec_from_profile(
        "plugin=jerasure k=8 m=4 technique=cauchy_good", device=dev)
    op = codec.operand(codec.coding_bits)
    widths = [8 * 3001, 8 * 517, 8 * 12347]
    offs = [3, 3 + widths[0] + 5, 3 + widths[0] + 5 + widths[1] + 1]
    P = offs[-1] + widths[-1] + 7
    x = torch.randint(0, 256, (8, P), dtype=torch.uint8, device=dev)
    out = torch.randint(0, 256, (4, P), dtype=torch.uint8, device=dev)
    want = gf2_matmul.gf2_matmul_packets_plain(op, x, out.clone(), offs,
                                               widths, 8)
    gf2_matmul.gf2_matmul_packets(op, x, out, offs, widths, 8)
    assert torch.equal(out, want)


def test_crc_kernel_equals_plain(dev):
    rows = torch.randint(0, 256, (513, 4099), dtype=torch.uint8, device=dev)
    lens = np.arange(0, 4097, 8)[:513] + np.arange(513) % 8
    lens = np.minimum(lens, 4096)
    inits = np.arange(513, dtype=np.uint32) * 2654435761
    for view in (rows[:, :4096], rows[:, 3:]):
        got = cd.crc32c_lanes(view, lens, inits)
        want = cd.crc32c_lanes_plain(view, lens, inits).cpu().numpy()
        assert np.array_equal(got, want.astype(np.uint32))
    full = rows[:12]
    got = cd.crc32c_rows(full, [0, 5, 2000], [5, 1995, 2099], [1, 2, 3])
    want = cd.crc32c_rows(full.cpu(), [0, 5, 2000], [5, 1995, 2099],
                          [1, 2, 3])
    assert np.array_equal(got, want)


def test_gf2_xor_and_popcount_kernels_agree_on_a_jerasure_operand(dev):
    """The same cauchy_good operand through the XOR kernel (the wrapper's
    choice) and through the popcount kernel (its internal launch helper),
    on an aligned 2-job batch and a ragged 3-job one: both equal plain."""
    codec = codec_from_profile(
        "plugin=jerasure k=8 m=4 technique=cauchy_good", device=dev)
    g = torch.Generator(device=dev).manual_seed(41)
    for M, rout in ((codec.coding_bits, 4),
                    (codec.recovery_bits([0, 1, 2, 3, 4, 5, 8, 9]), 8)):
        op = codec.operand(M)
        assert op.packet is not None
        for widths, offs in (([131072] * 2, [0, 131072]),
                             ([8 * 3001, 8 * 517, 8 * 12347],
                              [3, 24016, 28153])):
            P = offs[-1] + widths[-1] + 7
            x = torch.randint(0, 256, (8, P), dtype=torch.uint8, device=dev,
                              generator=g)
            out = torch.randint(0, 256, (rout, P), dtype=torch.uint8,
                                device=dev, generator=g)
            want = gf2_matmul.gf2_matmul_packets_plain(
                op, x, out.clone(), offs, widths, 8)
            before = gf2_matmul.xor_launches.value
            xo = gf2_matmul.gf2_matmul_packets(op, x, out.clone(), offs,
                                               widths, 8)
            assert gf2_matmul.xor_launches.value == before + 1
            assert torch.equal(xo, want)
            before = gf2_matmul.launches.value
            po = out.clone()
            gf2_matmul._launch(op, x, po, np.asarray(offs, np.int64),
                               np.asarray(widths, np.int64), 8)
            assert gf2_matmul.launches.value == before + 1
            assert torch.equal(po, want)


def test_gf2_xor_kernel_in_place(dev):
    """out may be x itself when R == K: a block stages every input row of
    its tile before it writes the tile."""
    codec = codec_from_profile(
        "plugin=jerasure k=8 m=4 technique=cauchy_good", device=dev)
    op = codec.operand(codec.recovery_bits([0, 1, 2, 3, 4, 5, 8, 9]))
    x = torch.randint(0, 256, (8, 1 << 17), dtype=torch.uint8, device=dev)
    want = gf2_matmul.gf2_matmul_packets_plain(op, x, x.clone(), [0],
                                               [1 << 17], 8)
    gf2_matmul.gf2_matmul_packets(op, x, x, [0], [1 << 17], 8)
    assert torch.equal(x, want)


def test_gf2_popcount_kernel_runs_shec_decode(dev):
    sh = codec_from_profile("plugin=shec k=8 m=4 c=3", device=dev)
    _, s_op, contrib_op = sh.solve_operands((0, 1, 2), tuple(range(3, 12)))
    x = torch.randint(0, 256, (8, 131072), dtype=torch.uint8, device=dev)
    before = (gf2_matmul.xor_launches.value, gf2_matmul.launches.value)
    got = gf2_matmul.gf2_matmul_bytes(contrib_op, x)
    assert (gf2_matmul.xor_launches.value,
            gf2_matmul.launches.value) == (before[0], before[1] + 1)
    assert torch.equal(got, gf2_matmul.gf2_matmul_bytes_plain(contrib_op, x))


def _popcount(op, x, out, offs, widths, w):
    """One launch of the popcount (tensor-core) kernel, whatever the
    operand's structure; its count moves by one."""
    before = gf2_matmul.launches.value
    gf2_matmul._launch(op, x, out, np.asarray(offs, np.int64),
                       np.asarray(widths, np.int64), w)
    assert gf2_matmul.launches.value == before + 1
    return out


POPCOUNT_K = [1, 3, 4, 5, 8, 16, 17, 32, 33, 64, 65, 128]
POPCOUNT_N = [1, 3, 15, 16, 17, 4099, 1000003]


@pytest.mark.parametrize("R", [1, 3, 8, 17, 96])
@pytest.mark.parametrize("K", POPCOUNT_K)
def test_gf2_popcount_kernel_bucket_edges(dev, K, R):
    """Random 0/1 and -3..3 matrices at every step-bucket edge of K, over
    ragged widths, through the tensor-core kernel: bit-equal to plain."""
    rng = np.random.default_rng(1000 * K + R)
    g = torch.Generator(device=dev).manual_seed(K * 131 + R)
    for lo, hi in ((0, 2), (-3, 4)):
        op = gf2_matmul.BitOperand(
            rng.integers(lo, hi, (8 * R, 8 * K), dtype=np.int8))
        for n in POPCOUNT_N:
            x = torch.randint(0, 256, (K, n), dtype=torch.uint8, device=dev,
                              generator=g)
            got = _popcount(op, x, torch.empty((R, n), dtype=torch.uint8,
                                               device=dev), [0], [n], 1)
            assert torch.equal(got, gf2_matmul.gf2_matmul_bytes_plain(op, x)), \
                f"K={K} R={R} n={n} entries {lo}..{hi - 1}"


@pytest.mark.parametrize("kin,rout", [(1, 1), (4, 2), (8, 4), (16, 3)])
def test_gf2_popcount_kernel_packet_batch(dev, kin, rout):
    """A 3-job batch with w = 8 at odd offsets and unequal widths: each
    job's packets through the kernel equal plain; columns between jobs
    keep their bytes."""
    w = 8
    rng = np.random.default_rng(kin * 10 + rout)
    op = gf2_matmul.BitOperand(
        rng.integers(-3, 4, (8 * w * rout, 8 * w * kin), dtype=np.int8))
    widths = [w * 3001, w * 517, w * 12347]
    offs = [3, 3 + widths[0] + 5, 3 + widths[0] + 5 + widths[1] + 1]
    P = offs[-1] + widths[-1] + 7
    g = torch.Generator(device=dev).manual_seed(kin + 17 * rout)
    x = torch.randint(0, 256, (kin, P), dtype=torch.uint8, device=dev,
                      generator=g)
    out = torch.randint(0, 256, (rout, P), dtype=torch.uint8, device=dev,
                        generator=g)
    want = gf2_matmul.gf2_matmul_packets_plain(op, x, out.clone(), offs,
                                               widths, w)
    assert torch.equal(_popcount(op, x, out, offs, widths, w), want)


@pytest.mark.parametrize("K", [3, 8, 32, 33, 128])
@pytest.mark.parametrize("n", [4099, 1 << 17])
def test_gf2_popcount_kernel_in_place(dev, K, n):
    """out may be x itself when R == K: a warp reads every input row of
    its columns before it writes them."""
    op = gf2_matmul.BitOperand(np.random.default_rng(K).integers(
        -3, 4, (8 * K, 8 * K), dtype=np.int8))
    x = torch.randint(0, 256, (K, n), dtype=torch.uint8, device=dev)
    want = gf2_matmul.gf2_matmul_bytes_plain(op, x)
    _popcount(op, x, x, [0], [n], 1)
    assert torch.equal(x, want)


@pytest.mark.parametrize("R,K", [(3, 8), (1, 40), (2, 128)])
def test_gf2_popcount_kernel_one_hot_matrices(dev, R, K):
    """A matrix with one set entry per (output bit, input bit) copies that
    input bit to that output bit and nothing else: pins which fragment
    row, column and k-bit each operand word stands for."""
    n = 67
    x = torch.randint(0, 256, (K, n), dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(R * K)
    pairs = [(rb, kb) for rb in range(8 * R) for kb in range(8 * K)]
    if len(pairs) > 2048:  # every output bit and every input bit, sampled
        pick = rng.choice(len(pairs), 2048, replace=False)
        pairs = [pairs[i] for i in pick] + [(rb, rb % (8 * K))
                                            for rb in range(8 * R)] + \
            [(kb % (8 * R), kb) for kb in range(8 * K)]
    for rb, kb in pairs:
        mbits = np.zeros((8 * R, 8 * K), np.int8)
        mbits[rb, kb] = 1
        op = gf2_matmul.BitOperand(mbits)
        got = _popcount(op, x, torch.empty((R, n), dtype=torch.uint8,
                                           device=dev), [0], [n], 1)
        want = torch.zeros((R, n), dtype=torch.uint8, device=dev)
        want[rb // 8] = ((x[kb // 8] >> (kb % 8)) & 1) << (rb % 8)
        assert torch.equal(got, want), f"one-hot ({rb}, {kb})"


@pytest.mark.parametrize("shift", [0, 1, 7, 13])
def test_crc_kernel_at_segment_boundaries(dev, shift):
    """Rows of length 0, 1, seg-1, seg, seg+1, 3*seg+7 (seg = the
    kernel's 8 KiB segment) and 64 KiB + 5 at odd column offsets of a
    12-shard batch: the two-pass kernel equals the CPU path."""
    seg = 8192
    lens = [0, 1, seg - 1, seg, seg + 1, 3 * seg + 7, (64 << 10) + 5]
    offs, o = [], shift
    for ln in lens:
        offs.append(o)
        o += ln + 3
    full = torch.randint(0, 256, (12, o + 16), dtype=torch.uint8, device=dev)
    inits = [(i * 2654435761) & 0xFFFFFFFF for i in range(len(lens))]
    before = cd.launches.value
    got = cd.crc32c_rows(full, offs, lens, inits)
    assert cd.launches.value == before + 1
    assert np.array_equal(got, cd.crc32c_rows(full.cpu(), offs, lens, inits))


def test_queue_encp_on_cauchy_good(dev):
    """The queue's fused encode + CRC batch on a bit-matrix codec: coding
    equal to the CPU codec's, CRCs equal to the plain CRC of each stored
    shard, through the XOR kernel and never the popcount kernel."""
    profile = "plugin=jerasure k=8 m=4 technique=cauchy_good packetsize=2048"
    codec = codec_from_profile(profile, device=dev)
    host = codec_from_profile(profile, device="cpu")
    si = StripeInfo(8, 128 << 10)
    rng = np.random.default_rng(5)
    planes = [si.interleave(rng.integers(0, 256, 4 << 20,
                                         dtype=np.uint8).tobytes())[0]
              for _ in range(4)]
    before = (gf2_matmul.xor_launches.value, gf2_matmul.launches.value)
    q = StripeBatchQueue(device=dev)
    try:
        res = [f.result(timeout=120) for f in
               [q.encode_crc_async(codec, p) for p in planes]]
    finally:
        q.stop()
    assert gf2_matmul.xor_launches.value > before[0]
    assert gf2_matmul.launches.value == before[1]
    for p, (c, crcs) in zip(planes, res):
        assert np.array_equal(c, host.encode_array(p))
        shards = torch.from_numpy(np.concatenate([p, c]))
        assert np.array_equal(crcs, cd.crc32c_lanes(
            shards, np.full(12, p.shape[1])))


def test_queue_write_and_degraded_read_on_the_card(dev):
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    si = StripeInfo(8, 128 << 10)
    rng = np.random.default_rng(3)
    objs = [rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
            for _ in range(4)]
    q = StripeBatchQueue(device=dev)
    try:
        planes = [si.interleave(o)[0] for o in objs]
        res = [f.result(timeout=120) for f in
               [q.encode_crc_async(codec, p) for p in planes]]
        for p, (c, crcs) in zip(planes, res):
            assert np.array_equal(c, codec.encode_array(p))
            shards = torch.from_numpy(np.concatenate([p, c]))
            assert np.array_equal(crcs, cd.crc32c_lanes(
                shards.to(dev), np.full(12, p.shape[1])))
        for o, p, (c, _) in zip(objs, planes, res):
            avail = {s: p[s] if s < 8 else c[s - 8]
                     for s in (0, 1, 2, 3, 4, 5, 8, 9)}
            d = q.decode_data_async(codec, avail).result(timeout=120)
            assert si.deinterleave(d, len(o)) == o
    finally:
        q.stop()


def _tiles(T):
    return [t for t in (1, 8, 32, 128, 256, 512, 1024) if T % t == 0]


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (3, 3)])
@pytest.mark.parametrize("T", [128, 4096])
def test_gf256_interleaved_kernel_equals_plain(dev, k, m, T):
    coding = matrices.isa_cauchy(k, m)
    seed = 0xA5A5A5A5
    w3 = benchloop.gen_planes(k, T, interleaved=True, device=dev)
    want = gf256_planes.encode_planes_interleaved_plain(coding, w3, seed)
    for tile in _tiles(T):
        for ms in (False, True):
            before = gf256_planes.launches.value
            got = gf256_planes.encode_planes_interleaved(
                coding, w3, seed, tile=tile, mul_shift=ms)
            assert gf256_planes.launches.value == before + 1
            assert torch.equal(got, want), (tile, ms)


@pytest.mark.parametrize("R", K1_EDGES)
@pytest.mark.parametrize("k", K1_EDGES)
def test_gf256_interleaved_kernel_bucket_edges(dev, R, k):
    """K2 on K1's operand at every bucket edge: an odd T (the grid's last
    block half full) and T = 4096, both seeds and both doubling variants;
    a matrix past 16 x 16 launches once per row block of 16, each
    writing its rows of every T-row, and the count says so."""
    rng = np.random.default_rng(R * 64 + k + 7)
    mat = rng.integers(0, 256, (R, k), dtype=np.uint8)
    nl = len(gf256.k1_operand(mat).blocks)
    assert nl == (2 if R > 16 and k > 16 else 1)
    for T, tile in ((257, 1), (4096, 512)):
        w3 = benchloop.gen_planes(k, T, interleaved=True, device=dev)
        for seed in (0, 0xA5A5A5A5):
            want = gf256_planes.encode_planes_interleaved_plain(mat, w3,
                                                                seed)
            for ms in (False, True):
                before = gf256_planes.launches.value
                got = gf256_planes.encode_planes_interleaved(
                    mat, w3, seed, tile=tile, mul_shift=ms)
                assert gf256_planes.launches.value == before + nl
                assert torch.equal(got, want), (T, seed, ms)


def test_gf256_interleaved_kernel_refuses_an_overlapping_output(dev):
    coding = matrices.isa_cauchy(4, 4)
    w3 = benchloop.gen_planes(4, 128, interleaved=True, device=dev)
    with pytest.raises(ValueError, match="write over its input"):
        gf256_planes.encode_planes_interleaved(coding, w3, tile=128, out=w3)


def test_gf256_planar_planes_entry_equals_plain(dev):
    coding = matrices.isa_cauchy(8, 4)
    w3 = benchloop.gen_planes(8, 4096, device=dev)
    want = gf256_planes.encode_planes_plain(coding, w3, 7)
    for ms in (False, True):
        before = gf256.launches.value
        got = gf256_planes.encode_planes(coding, w3, 7, tile=128,
                                         mul_shift=ms)
        assert gf256.launches.value == before + 1
        assert torch.equal(got, want)
    inter = gf256_planes.encode_planes_interleaved(
        coding, w3.transpose(0, 1).contiguous(), 7, tile=128)
    assert torch.equal(inter.transpose(0, 1), want)


def test_graph_loop_digest_equals_eager_cpu(dev):
    coding = matrices.isa_cauchy(8, 4)
    for inter, factory in ((False, ecbench.planar_engine),
                           (True, ecbench.inter_engine)):
        w3 = benchloop.gen_planes(8, 256, inter, device=dev)
        enc = factory(coding, 128)
        got = benchloop.sum_digest_runner(enc, 3)(w3)
        want = benchloop.sum_digest_runner(enc, 3)(w3.cpu())
        assert got == want
        fold = benchloop.seeded_loop_runner(enc, tuple(
            enc(w3, 0).shape), 3)
        assert fold(w3) == fold(w3.cpu())


def test_ecbench_runs_on_the_card_at_small_sizes(dev):
    before = gf256_planes.launches.value
    res = ecbench.run(dev, sweep=((256, 4), (1024, 4)), tiles=(128, 256),
                      pin_T=256, tune_T=1024, target_s=0.005, cap_s=0.05,
                      start_iters=4, small_objs=512, small_min_T=8,
                      envelope_bytes=1 << 24, matmul_n=256)
    assert gf256_planes.launches.value > before
    assert res["ec_device_pinned"] == {"planar": True, "inter": True}
    assert res["ec_decode_pinned"] is True
    assert res["timing"] == "cuda_graph"
    assert all(isinstance(r["decode_gbps"], float)
               for r in res["ec_sweep"].values())


# -- K6: the CRUSH rule walk -------------------------------------------------

CRUSH_CASES = [c.name for c in samples.cases()]


def _crush_walk(dev, case, xs, budget):
    flat = case.map.flatten()
    rm = mapper.device_map(flat, case.choose_args, dev)
    spec = crush_rule.RuleSpec(case.steps, case.result_max)
    w = torch.from_numpy(case.dev_weights.view(np.int32)).to(dev)
    x = torch.from_numpy(xs).to(dev)
    out = torch.empty((len(xs), case.result_max), dtype=torch.int32,
                      device=dev)
    clean = torch.empty(len(xs), dtype=torch.uint8, device=dev)
    before = crush_rule.launches.value
    crush_rule.launch(rm, spec, w, x, out, budget=budget, clean=clean)
    assert crush_rule.launches.value == before + 1
    torch.cuda.synchronize()
    want, want_clean = crush_rule.rule_plain(rm, spec, w, x, budget)
    return out, clean.bool(), want, want_clean


@pytest.mark.parametrize("budget", [0, 1, 3])
@pytest.mark.parametrize("name", CRUSH_CASES)
def test_crush_kernel_equals_plain_on_every_sample(dev, name, budget):
    case = samples.case(name)
    out, clean, want, want_clean = _crush_walk(dev, case,
                                               samples.ids(17, 2048), budget)
    assert torch.equal(out, want)
    assert torch.equal(clean, want_clean)


def test_crush_kernel_budgets_clean_rows_are_the_full_walk(dev):
    case = samples.case("chooseleaf_firstn_3")
    xs = samples.ids(3, 1 << 16)
    full = _crush_walk(dev, case, xs, 0)[0]
    for budget in (1, 3):
        out, clean, _, _ = _crush_walk(dev, case, xs, budget)
        assert 0 < int(clean.sum()) < len(xs)
        assert torch.equal(out[clean], full[clean])


@pytest.mark.parametrize("budget", [0, 1, 3])
def test_crush_kernel_equals_plain_on_a_mixed_weight_map(dev, budget):
    """Every fourth OSD at twice the weight: the host buckets' straw2
    scans mix the hash-order path with the exact draw and its
    reciprocal divide."""
    m, root = samples.weighted_cluster(1024, 64)
    flat = m.flatten()
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
             (cmap.OP_EMIT, 0, 0)]
    rm = mapper.device_map(flat, device=dev)
    spec = crush_rule.RuleSpec(steps, 3)
    w = torch.full((1024,), 0x10000, dtype=torch.int32, device=dev)
    x = torch.from_numpy(samples.ids(5, 1 << 16)).to(dev)
    out = torch.empty((1 << 16, 3), dtype=torch.int32, device=dev)
    clean = torch.empty(1 << 16, dtype=torch.uint8, device=dev)
    stats = torch.zeros(crush_rule.N_STATS, dtype=torch.int64, device=dev)
    crush_rule.launch(rm, spec, w, x, out, budget=budget, clean=clean,
                      stats=stats)
    want, want_clean = crush_rule.rule_plain(rm, spec, w, x, budget)
    assert torch.equal(out, want)
    assert torch.equal(clean.bool(), want_clean)
    draws, _, _, exact = stats.tolist()
    assert 0.05 * draws < exact < draws


def test_crush_exact_path_count_is_positive_and_rare(dev):
    """On the BASELINE map (one weight a bucket) only hash distances of
    1 take the exact draw: about 2 comparisons in 65536."""
    m, root = cmap.build_flat_cluster(1024, hosts=64)
    rm = mapper.device_map(m.flatten(), device=dev)
    spec = crush_rule.RuleSpec([(cmap.OP_TAKE, root, 0),
                                (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
                                (cmap.OP_EMIT, 0, 0)], 3)
    x = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    out = torch.empty((1 << 20, 3), dtype=torch.int32, device=dev)
    stats = torch.zeros(crush_rule.N_STATS, dtype=torch.int64, device=dev)
    crush_rule.launch(rm, spec, torch.full((1024,), 0x10000,
                                           dtype=torch.int32, device=dev),
                      x, out, stats=stats)
    draws, _, chooses, exact = stats.tolist()
    assert chooses >= 6 << 20 and draws >= 240 << 20
    assert 0 < exact < draws // 10000
    with pytest.raises(ValueError):
        crush_rule.launch(rm, spec, torch.full((1024,), 0x10000,
                                               dtype=torch.int32, device=dev),
                          x, out, stats=stats[:3])


def test_crush_sweep_device_makes_n_chunks_plus_two_launches(dev):
    m, root = cmap.build_flat_cluster(1024, hosts=64)
    flat = m.flatten()
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
             (cmap.OP_EMIT, 0, 0)]
    xs = torch.arange(1 << 18, dtype=torch.int32, device=dev)
    dw = np.full(1024, 0x10000, dtype=np.uint32)
    exact = mapper.compile_rule(flat, steps, 3, device=dev)(xs, dw)
    before = crush_rule.launches.value
    events = {}
    got, overflow = mapper.sweep_device(flat, steps, 3, xs, dw, chunk=1 << 15,
                                        device=dev, stage_events=events)
    assert crush_rule.launches.value == before + 8 + 2
    assert {k: len(v) for k, v in events.items()} == {1: 8, 2: 1, 3: 1}
    assert not bool(overflow)
    assert torch.equal(got, exact)


def test_crush_compile_rule_on_the_card_equals_plain_at_scale(dev):
    m, root = cmap.build_flat_cluster(1024, hosts=64)
    flat = m.flatten()
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
             (cmap.OP_EMIT, 0, 0)]
    xs = np.arange(1 << 18, dtype=np.int32)
    dw = np.full(1024, 0x10000, dtype=np.uint32)
    got = mapper.compile_rule(flat, steps, 3, device=dev)(xs, dw)
    want = mapper.compile_rule(flat, steps, 3, device="cpu")(xs[:4096], dw)
    assert torch.equal(got[:4096].cpu(), want)
    rm = mapper.device_map(flat, device=dev)
    plain, _ = crush_rule.rule_plain(
        rm, crush_rule.RuleSpec(steps, 3),
        torch.from_numpy(dw.view(np.int32)).to(dev),
        torch.from_numpy(xs).to(dev))
    assert torch.equal(got, plain)


def test_crush_sweep_device_matches_exact_and_flags_overflow(dev):
    m, root = cmap.build_flat_cluster(64, hosts=8)
    flat = m.flatten()
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
             (cmap.OP_EMIT, 0, 0)]
    dw = np.full(64, 0x10000, dtype=np.uint32)
    dw[5], dw[17], dw[40] = 0, 0x4000, 0
    xs = np.arange(1 << 16, dtype=np.int32)
    exact = mapper.compile_rule(flat, steps, 3, device=dev)(xs, dw)
    # 8 hosts for 3 replicas retry far more than the 64-host map: half
    # capacity at stage 2 and a quarter of the ids at stage 3
    got, overflow = mapper.sweep_device(flat, steps, 3, xs, dw, chunk=4096,
                                        bad_div=2, bad2_div=4, device=dev)
    assert not bool(overflow)
    assert torch.equal(got, exact)
    host = mapper.sweep(flat, steps, 3, xs, dw, chunk=8192, device=dev)
    assert np.array_equal(host, exact.cpu().numpy())
    low = np.zeros(64, dtype=np.uint32)
    low[:4] = 0x10000
    _, overflow = mapper.sweep_device(flat, steps, 3, xs[:1024], low,
                                      chunk=1024, bad_div=256, device=dev)
    assert bool(overflow)
    got, overflow = mapper.sweep_device(flat, steps, 3, xs[:1024], low,
                                        chunk=1024, bad_div=1, bad2_div=1,
                                        device=dev)
    assert not bool(overflow)
    assert torch.equal(got, mapper.compile_rule(flat, steps, 3, device=dev)(
        xs[:1024], low))


def test_crush_kernel_append_buffer_counts_past_capacity(dev):
    case = samples.case("chooseleaf_firstn_3")
    flat = case.map.flatten()
    rm = mapper.device_map(flat, device=dev)
    spec = crush_rule.RuleSpec(case.steps, 3)
    dw = case.dev_weights.copy()
    dw[[3, 7, 20]] = 0
    w = torch.from_numpy(dw.view(np.int32)).to(dev)
    xs = torch.from_numpy(samples.ids(2, 4096)).to(dev)
    out = torch.empty((4096, 3), dtype=torch.int32, device=dev)
    bad = torch.full((64,), -1, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    crush_rule.launch(rm, spec, w, xs, out, budget=1, bad=bad,
                      bad_count=count, idx_base=100000)
    _, clean = crush_rule.rule_plain(rm, spec, w, xs, 1)
    unclean = set((torch.nonzero(~clean).squeeze(1) + 100000).tolist())
    assert int(count[0]) == len(unclean) > 64
    got = bad.tolist()
    assert len(set(got)) == 64 and set(got) <= unclean


# -- the core layer on the card's path ----------------------------------------


def test_core_queue_under_lockdep_on_the_card(dev):
    """A queue built with the port's lockdep armed writes and
    degraded-reads on the card with checked locks and no
    LockOrderError; the CRCs equal the host CRC-32C of each shard."""
    from ceph_tpu_torch.core import lockdep
    from ceph_tpu_torch.core.crc import crc32c

    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    rng = np.random.default_rng(13)
    planes = [rng.integers(0, 256, (8, 128 << 10), dtype=np.uint8)
              for _ in range(6)]
    try:
        q = StripeBatchQueue(device=dev)
        assert isinstance(q.pool._cond._lock, lockdep.DMutex)
        try:
            res = [f.result(timeout=120) for f in
                   [q.encode_crc_async(codec, p) for p in planes]]
            for p, (c, crcs) in zip(planes, res):
                assert np.array_equal(c, codec.encode_array(p))
                assert [int(x) for x in crcs] == \
                    [crc32c(s) for s in list(p) + list(c)]
            for p, (c, _) in zip(planes, res):
                avail = {s: p[s] if s < 8 else c[s - 8]
                         for s in (0, 1, 2, 3, 4, 5, 8, 9)}
                d = q.decode_data_async(codec, avail).result(timeout=120)
                assert np.array_equal(d, p)
        finally:
            q.stop()
        assert "staging.stats" in lockdep.edge_graph()["staging.pool"]
    finally:
        lockdep.enable(was)
        lockdep.reset()


def test_core_dispatch_failpoint_on_the_card(dev):
    """queue.batch.dispatch armed once with an error fails exactly the
    jobs of one batch on the card; the next writes complete."""
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.core.crc import crc32c

    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    rng = np.random.default_rng(14)
    planes = [rng.integers(0, 256, (8, 64 << 10), dtype=np.uint8)
              for _ in range(6)]
    seen = []

    def fail(ctx):
        seen.append(ctx["jobs"])
        fp.error()(ctx)

    fp.disarm_all()
    q = StripeBatchQueue(device=dev)
    try:
        fp.arm("queue.batch.dispatch", fail, once=True)
        futs = [q.encode_crc_async(codec, p) for p in planes]
        failed = [f for f in futs
                  if isinstance(f.exception(timeout=120), fp.FailpointError)]
        assert fp.hits("queue.batch.dispatch") == 1
        assert len(failed) == seen[0] and q.jobs == len(planes) - seen[0]
        for p in planes:
            c, crcs = q.encode_crc_async(codec, p).result(timeout=120)
            assert [int(x) for x in crcs] == \
                [crc32c(s) for s in list(p) + list(c)]
    finally:
        q.stop()
        fp.disarm_all()


# -- the wire slice on the card's path ----------------------------------------


def test_wire_path_on_the_card(dev):
    """The wire phase's code at a small size: MOSDOps through the port's
    PG and its ECBackend with the card's shards (primary osd.0 and four
    peers, cephx on), one peer down and one shard rotten; K1 and the CRC
    kernel launch in the write, K1 in the degraded read, and every byte
    comes back.  The phase's checks hold: no op in flight, every write
    staged and none degraded, the primary's shards applied through
    op_payload before each seal, no host CRC in the backend's write,
    each stored hinfo the card's CRC, every read decoded (none warm),
    the rotten shard counted once an object, every PG's head at the
    last write."""
    import chip_smoke
    from ceph_tpu_torch.osd.backend import hinfo_decode

    res = chip_smoke.run_wire(torch, dev, nobj=4, obj_bytes=1 << 20,
                              threads=2, recover=False)
    assert res["staged"] == {"staged": 4, "degraded": 0}
    assert res["dec_jobs"] == 4 and res["scrub_errors"] == 4
    assert res["heads"] == {o: "7'4" for o in range(5)}
    assert res["lost"] == [4, 6, 9]
    assert res["w_counts"]["gf256_matmul"] > 0
    assert res["w_counts"]["crc32c_rows"] > 0
    assert res["r_counts"]["gf256_matmul"] > 0
    assert res["seal_fails"] == 4 and res["refused"] >= 2
    for i, obj in enumerate(res["objs"]):
        assert res["decoded"][i] == obj.tobytes()
    width = res["coding"][0].shape[1]
    dp = res["devpath"]
    assert dp["payload_host_touches"] == 0 and dp["write_host_crcs"] == 0
    assert dp["d2h_bytes"] == 4 * 4 * width
    assert dp["seals"] == 4 and dp["local_applied"] == 4 * 3
    assert sum(w * c for w, c in res["batch_jobs"].items()) == 4
    assert res["devbuf"]["on"].startswith("cuda")
    assert res["devbuf"]["k1_launches"] == 1
    assert res["devbuf"]["d2h_grew"] == 4 * width
    assert sorted(res["pg_omaps"]) == [0, 1, 2, 3, 4]
    assert all(len([k for k in o if k[0].isdigit()]) == 4
               for o in res["pg_omaps"].values())
    for hinfos in res["hinfos"].values():
        for (i, s), blob in hinfos.items():
            assert hinfo_decode(blob) == (1 << 20, res["crcs"][i][s], True)


@pytest.mark.parametrize("name", ["isa_2_1", "isa_8_4", "shec_8_4_3",
                                  "lrc_4_2_3"])
def test_backend_write_and_degraded_read_on_the_card(dev, name):
    """The backend's write sequence (a staged full write, a second
    object, a rewrite, a partial write, a delete) with codecs on the
    card, held to the same sequence with ``device="cpu"`` codecs: the
    same messages, the same stored shards, xattrs and omaps, the same
    degraded reads; the RS writes launch K1 and the CRC kernel, the RS
    reads K1."""
    import test_torch_backend_xcheck as xc

    profile, osds = xc.PROFILES[name]
    cpu = xc._Cluster("ceph_tpu_torch", profile, osds)
    want = xc._script(cpu, np.random.default_rng(31))
    card = xc._Cluster("ceph_tpu_torch", profile, osds, device=dev)
    assert card.primary.queue.device.type == "cuda"
    k1, crc = gf256.launches.value, cd.launches.value
    assert xc._script(card, np.random.default_rng(31)) == want
    if "isa" in name:
        assert gf256.launches.value > k1 and cd.launches.value > crc
    assert card.sent == cpu.sent
    assert card.dump() == cpu.dump()
    lost = xc._lost(card)
    k1 = gf256.launches.value
    got = xc._reconstruct_async(card, "a", lost)
    assert xc._state(got) == xc._state(xc._reconstruct_async(cpu, "a", lost))
    assert got.data == want["a3"]
    if "isa" in name:
        assert gf256.launches.value > k1


@pytest.mark.parametrize("name", ["isa_2_1", "isa_8_4"])
def test_devbuf_write_onto_blockstores_reads_at_rest_on_the_card(
        dev, name, tmp_path):
    """The backend's write sequence onto BlockStores with codecs on the
    card (its first write a ``DeviceBuf`` through ``ECBackend.submit``:
    K1 and the CRC kernel, the payload fetched once through
    ``op_payload(op, copy=True)``), held to the same on the CPU: the same
    messages and stores; each shard's extent read back through
    ``read_local_chunk_extent2``'s ``checksums_at_rest`` route equals the
    CPU run's."""
    import test_torch_backend_xcheck as xc

    profile, osds = xc.PROFILES[name]
    cpu = xc._Cluster("ceph_tpu_torch", profile, osds,
                      store_dir=str(tmp_path / "cpu"))
    card = xc._Cluster("ceph_tpu_torch", profile, osds, device=dev,
                       store_dir=str(tmp_path / "card"))
    try:
        want = xc._script(cpu, np.random.default_rng(31))
        k1, crc = gf256.launches.value, cd.launches.value
        assert xc._script(card, np.random.default_rng(31)) == want
        assert gf256.launches.value > k1 and cd.launches.value > crc
        assert card.sent == cpu.sent
        assert card.dump() == cpu.dump()
        assert all(st.checksums_at_rest for st in card.stores.values())
        off, length = 100, card.primary.unit - 200
        got = card.ranged("a", off, length)
        assert got == cpu.ranged("a", off, length)
        assert all(code == 0 for _data, code in got.values())
    finally:
        cpu.umount()
        card.umount()


def test_recovery_engine_over_a_stub_pg_on_the_card(dev):
    """The recovery engine's aggregation window over the stub PG with
    the port's codec on the card: the same messages and recovered shards
    as with ``device="cpu"``, its reconstructs through K1."""
    import test_torch_recovery as tr

    cpg, cosd, oids, _ = tr._aggregation_window("ceph_tpu_torch")
    k1 = gf256.launches.value
    gpg, gosd, _, _ = tr._aggregation_window("ceph_tpu_torch", device=dev)
    assert gpg.backend.queue.device.type == "cuda"
    assert gf256.launches.value > k1
    with gpg.lock:
        assert not gpg.missing
    assert [(o, v.to_bytes()) for o, v in gosd.sent] == \
        [(o, v.to_bytes()) for o, v in cosd.sent]
    G = gpg.mods["objectstore"].GHObject
    for oid in oids:
        for shard in (0, 3):
            assert gosd.store.read(gpg.coll, G(oid, shard=shard)) == \
                cosd.store.read(cpg.coll, G(oid, shard=shard))
            assert gosd.store.getattrs(gpg.coll, G(oid, shard=shard)) == \
                cosd.store.getattrs(cpg.coll, G(oid, shard=shard))


def test_recovery_phase_on_the_card(dev):
    """The recovery phase's code at a small size, on the wire phase's
    PGs: the primary's shards 0, 5 and 10 of four objects lost and
    rebuilt by ``PG.recovery_engine()`` through K1, each equal to the
    shard written (the phase's own check), in two rounds of one vec a
    peer."""
    import chip_smoke

    res = chip_smoke.run_wire(torch, dev, nobj=4, obj_bytes=1 << 20,
                              threads=2)
    rec = res["recovery"]
    assert rec["counts"]["gf256_matmul"] > 0
    assert rec["shards"] == 12 and rec["dec_jobs"] == 4
    assert rec["rounds"] == 2 and rec["subread_msgs"] <= 4 * 2


@pytest.mark.parametrize("name", ["isa_2_1", "isa_8_4"])
def test_pg_write_read_and_recovery_on_the_card(dev, name, monkeypatch):
    """The PG cross-check's sequence (writes, a ranged RMW, a degraded
    read, peering with a laggard push and a rollback, a recovery window)
    on port PGs whose codec is on the card, held to the same sequence
    with ``device="cpu"`` codecs: the same replies, messages, stores,
    infos and logs; K1 and the CRC kernel launch."""
    import time as _time

    import test_torch_pg_xcheck as px

    monkeypatch.setattr(_time, "time", lambda: px.CLOCK)
    profile, n_osds = px.PROFILES[name]
    want = px._sequence("ceph_tpu_torch", profile, n_osds, seed=18)
    k1, crc = gf256.launches.value, cd.launches.value
    got = px._sequence("ceph_tpu_torch", profile, n_osds, seed=18,
                       device=dev)
    assert gf256.launches.value > k1 and cd.launches.value > crc
    for key in want:
        assert got[key] == want[key], key


def test_scrub_phase_on_the_card(dev):
    """The scrub phase's code at a small size on the wire phase's PGs
    (six 1 MiB objects): the cls calls through ``do_op``, a clean shallow
    pass, a deep pass naming the rotten shard on every object through
    K1 with its decodes coalesced (a ``dec`` batch wider than one), five
    marked shards auto-repaired and a clean last pass (the phase's own
    checks)."""
    import chip_smoke

    res = chip_smoke.run_wire(torch, dev, nobj=6, obj_bytes=1 << 20,
                              threads=2, scrub=True)
    steps = res["scrub"]["steps"]
    for name in ("cls", "deep", "repair", "final"):
        assert steps[name]["counts"]["gf256_matmul"] > 0, name
    assert steps["cls"]["jobs"] == {"enc": 2, "encp": 0}
    assert steps["deep"]["dec_jobs"] == 6
    assert max(steps["deep"]["dec_widths"]) > 1
    assert steps["repair"]["scrub_perf"]["errors_repaired"] == 5
    assert steps["repair"]["sent"]["MPGPush"] == 4


@pytest.mark.parametrize("name", ["isa_2_1", "isa_8_4"])
def test_pg_scrub_and_repair_on_the_card(dev, name, monkeypatch):
    """The scrub cross-check's steps (shallow, deep, auto-repair,
    ``repair_objects``, ``repair()``, ``scrub()`` over injected rot)
    on port PGs whose codec is on the card, held to the same steps with
    ``device="cpu"`` codecs: the same errors, messages, stores, stamps
    and counters; K1 launches."""
    import time as _time

    import test_torch_pg_xcheck as px
    import test_torch_scrub_xcheck as sx

    monkeypatch.setattr(_time, "time", lambda: px.CLOCK)
    profile, n_osds = px.PROFILES[name]
    want = px._sequence("ceph_tpu_torch", profile, n_osds, seed=19,
                        then=sx._scrub_steps)
    k1 = []

    def steps(net):
        before = gf256.launches.value
        out = sx._scrub_steps(net)
        k1.append(gf256.launches.value - before)
        return out

    got = px._sequence("ceph_tpu_torch", profile, n_osds, seed=19,
                       device=dev, then=steps)
    assert k1[0] > 0
    for step in want["then"]:
        assert got["then"][step] == want["then"][step], step
    for key in want:
        assert got[key] == want[key], key


def test_devbuf_parity_tensor_on_the_card(dev):
    """The ``devbuf`` check: an object's parity by K1 on a CUDA tensor,
    wrapped by ``wrap_device`` as that tensor, reads back (one counted
    fetch of its size) equal to the queue's parity of the object."""
    from ceph_tpu_torch.gpu.staging import DeviceBuf

    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    rng = np.random.default_rng(16)
    planes = rng.integers(0, 256, (8, 128 << 10), dtype=np.uint8)
    q = StripeBatchQueue(device=dev)
    try:
        coding, _ = q.encode_crc_async(codec, planes).result(timeout=120)
        before = gf256.launches.value
        par = codec.encode_planes(torch.from_numpy(planes).to(dev))
        assert gf256.launches.value == before + 1 and par.is_cuda
        buf = DeviceBuf.wrap_device(par, q.stats)
        d0 = q.stats.d2h_bytes
        assert bytes(buf.wire_view()) == coding.tobytes()
        assert q.stats.d2h_bytes - d0 == coding.size
        assert buf[10:20] == coding.reshape(-1)[10:20].tobytes()
        assert q.stats.d2h_bytes - d0 == coding.size + 10
        assert q.stats.payload_host_touches == 0
    finally:
        q.stop()


def test_devicebuf_around_a_cuda_tensor(dev):
    """A staged payload on the queue's pinned pool whose planes are a
    CUDA tensor: the slot's view is a flat host buffer, the sealed
    handle reads its planes from the card (one counted fetch a read),
    and ``wrap_host`` refuses a tensor on the card."""
    from ceph_tpu_torch.gpu.staging import DeviceBuf, StagingPool

    q = StripeBatchQueue(device=dev)
    try:
        assert q.pool.pin and isinstance(q.pool, StagingPool)
        payload = np.random.default_rng(17).integers(
            0, 256, 96 << 10, dtype=np.uint8).tobytes()
        buf = DeviceBuf.stage(q.pool, payload)
        assert buf is not None and q.pool.occupancy == 1
        view = buf.wire_view()
        assert memoryview(view).cast("B").nbytes == len(payload)
        assert bytes(view) == payload and q.stats.d2h_bytes == 0
        si = StripeInfo(4, 8 << 10)
        planes, _ = si.interleave(payload)
        buf.attach_planes(torch.from_numpy(planes).to(dev), 4, 8 << 10)
        buf.seal()
        assert q.pool.occupancy == 0
        assert bytes(buf.wire_view()) == payload
        assert q.stats.d2h_bytes == len(payload)
        assert buf[100:164] == payload[100:164]
        assert buf.np1d().tobytes() == payload
        assert buf.tobytes() == payload
        assert q.stats.d2h_bytes == 3 * len(payload) + 64
        assert q.stats.payload_host_touches == 1
        with pytest.raises(ValueError):
            DeviceBuf.wrap_host(torch.zeros(8, dtype=torch.uint8,
                                            device=dev), q.stats)
    finally:
        q.stop()


# -- placement on the host on the card's path ---------------------------------

PLACE_SMALL = dict(n_osds=48, hosts=16, pools=(
    (1, "rbd", 1, 3, 2, 256, ""),
    (2, "ec84", 3, 12, 9, 64, "plugin=isa k=8 m=4 technique=reed_sol_van")))


def _placement_pair(dev):
    """The placement phase's map at a small size on the card, and the same
    map decoded onto the CPU (the plain walk)."""
    import chip_smoke
    from ceph_tpu_torch.osd import map_codec

    m = chip_smoke.placement_map(dev, PLACE_SMALL["n_osds"],
                                 PLACE_SMALL["hosts"], PLACE_SMALL["pools"])
    return m, map_codec.decode_osdmap(map_codec.encode_osdmap(m),
                                      device="cpu")


@pytest.mark.parametrize("pid", [1, 2])
def test_osdmap_map_pgs_kernel_equals_plain(dev, pid):
    m, cpu = _placement_pair(dev)
    assert m.device == dev
    before = crush_rule.launches.value
    got = m.map_pgs(pid)
    assert crush_rule.launches.value == before + 1
    want = cpu.map_pgs(pid)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pid", [1, 2])
def test_osdmap_scalar_path_is_one_launch_equal_to_plain(dev, pid):
    m, cpu = _placement_pair(dev)
    m.set_osd_down(3)
    m.set_osd_out(20)
    cpu.set_osd_down(3)
    cpu.set_osd_out(20)
    for ps in range(0, m.pools[pid].pg_num, 7):
        before = crush_rule.launches.value
        got = m.pg_to_up_acting((pid, ps))
        assert crush_rule.launches.value == before + 1
        assert got == cpu.pg_to_up_acting((pid, ps)), ps


def test_upmap_balancer_on_the_card_equals_plain(dev):
    from ceph_tpu_torch.mgr import UpmapBalancer
    from ceph_tpu_torch.osd import map_codec

    m, cpu = _placement_pair(dev)
    before = crush_rule.launches.value
    got = UpmapBalancer(m, max_deviation=0.5, max_moves=8).optimize()
    want = UpmapBalancer(cpu, max_deviation=0.5, max_moves=8).optimize()
    assert [r.moves for r in got] == [r.moves for r in want]
    assert any(r.moves for r in got)
    # each pool: a sweep before, one per move, one after
    assert crush_rule.launches.value == before + sum(
        len(r.moves) + 2 for r in got)
    assert map_codec.encode_osdmap(m) == map_codec.encode_osdmap(cpu)


def test_osdmaptool_on_the_card_equals_plain(dev, tmp_path):
    import contextlib
    import io

    from ceph_tpu_torch.tools import osdmaptool

    f = str(tmp_path / "osdmap")
    osdmaptool.main(["--createsimple", "32", "--pg_num", "128", "-o", f])
    outs = []
    for extra in ([], ["--device", "cpu"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert osdmaptool.main([f, "--test-map-pgs", "--upmap",
                                    "--upmap-max", "8"] + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and '"upmaps"' in outs[0]


def test_placement_phase_on_the_card(dev):
    """The placement phase's code at a small size: each step's launches
    as the phase counts them, every check of the phase."""
    import chip_smoke

    res = chip_smoke.run_placement(torch, dev, scalar=8, moves=6,
                                   compat_iters=2, tool_osds=16,
                                   tool_pg_num=64, reps=1, **PLACE_SMALL)
    assert res["launches"] > 0 and res["max_abs_err"] == 0
    assert res["balance"]["upmap_1"]["moves"] > 0


# -- the daemon on the card's path --------------------------------------------


def test_device_warmup_launches_every_declared_bucket_on_the_card(dev):
    """DeviceWarmup on the card: one K1 launch a width for the encode and
    one for the recovery product, one CRC launch a width, one K6 launch a
    pool (map_pgs), every item warmed."""
    import chip_smoke
    from ceph_tpu_torch.gpu import shapebucket as sb

    prof = "plugin=isa k=8 m=4 technique=reed_sol_van"
    codec = codec_from_profile(prof, device=dev)
    om = chip_smoke.daemon_map(dev, 12, prof, 8, 8)
    k1, crc, k6 = (gf256.launches.value, cd.launches.value,
                   crush_rule.launches.value)
    w = sb.DeviceWarmup(codec, crush=lambda: [om.map_pgs(p)
                                              for p in om.pools],
                        device=dev)
    st = w.run(-1)
    assert st["done"] and not st["skipped"]
    assert st["families_warmed"] == ["crc32c_rows", "crush_rule", "dec",
                                     "enc"]
    n = len(sb.WARM_COLS)
    assert gf256.launches.value - k1 == 2 * n
    assert cd.launches.value - crc == n
    assert crush_rule.launches.value - k6 == len(om.pools)


def test_warmed_write_path_is_steady_on_the_card(dev):
    """``tests/test_shapebucket.py:178`` on the card: after a
    DeviceWarmup pass, encode, fused CRC and decode batches at a warmed
    width run under the steady-state guard with no first launch, and the
    warmup's first launches of K1 and the CRC are classed warmup."""
    from ceph_tpu_torch.gpu import devwatch
    from ceph_tpu_torch.gpu import shapebucket as sb

    dw = devwatch.watch()
    seen0 = {(r["family"], r["sig"]) for r in dw.first_launches()}
    codec = codec_from_profile("plugin=isa k=2 m=1 technique=reed_sol_van",
                               device=dev)
    st = sb.DeviceWarmup(codec, cols=(4096,), device=dev).run(120.0)
    assert st["done"], st
    new = [r for r in dw.first_launches()
           if (r["family"], r["sig"]) not in seen0]
    assert all(r["class"] == "warmup" for r in new
               if r["family"] in ("gf256_matmul", "crc32c_rows")), new
    q = StripeBatchQueue(device=dev)
    g0 = len(devwatch.GUARD_VIOLATIONS)
    try:
        rng = np.random.default_rng(7)
        planes = rng.integers(0, 256, (2, 4096), np.uint8)
        with dw.steady_state():
            q.encode(codec, planes)
            q.encode_crc_async(codec, planes, size=8192).result(30.0)
            coding = q.encode(codec, planes)
            data = q.decode_data(codec, {1: planes[1], 2: coding[0]})
        assert devwatch.GUARD_VIOLATIONS[g0:] == []
        assert np.array_equal(data, planes)
    finally:
        del devwatch.GUARD_VIOLATIONS[g0:]
        q.stop()


def test_undeclared_first_launches_are_rogue_and_storm_on_the_card(dev):
    """K1 launched on the card at three undeclared widths: each first
    launch is classed rogue, timed with its stream's synchronize, and the
    third trips the rogue storm (``tpu_recompile_storm_min_rogue_sigs``,
    3) with its RECOMPILE_STORM WRN naming the churning axis; the
    products equal the plain version's."""
    import collections

    from ceph_tpu_torch.gpu import devwatch

    class _Log:
        def __init__(self):
            self.cluster_msgs = []

        def log(self, subsys, level, msg):
            pass

        def cluster(self, level, msg):
            self.cluster_msgs.append((level, msg))

    dw = devwatch.watch()
    saved = (dw._log, dw._recent, dw._storm_last, dw.storm_min_rogue_sigs,
             dw.storm_window_s)
    log = _Log()
    dw.attach_log(log)
    dw._recent = collections.deque(maxlen=512)
    dw._storm_last = {}
    dw.configure(window_s=60.0, min_rogue_sigs=3)
    try:
        # a 3 x 5 matrix no path of the port launches, at ragged widths
        # whose odd part is past the grammar's 63
        mat = np.arange(1, 16, dtype=np.uint8).reshape(3, 5)
        rng = np.random.default_rng(2028)
        base = dw.family_stats("gf256_matmul")["rogue"]
        storms = dw.perf.value("recompile_storms")
        for n in (12289, 12291, 12293):
            x = torch.from_numpy(rng.integers(0, 256, (5, n),
                                              dtype=np.uint8)).to(dev)
            got = gf256.gf_matmul_bytes(mat, x)
            assert torch.equal(got.cpu(),
                               gf256.gf_matmul_bytes_plain(mat, x.cpu()))
        assert dw.family_stats("gf256_matmul")["rogue"] - base == 3
        assert dw.perf.value("recompile_storms") == storms + 1
        storm = dw.dump()["storms"][-1]
        assert storm["family"] == "gf256_matmul"
        assert storm["kind"] == "rogue" and storm["rogue_signatures"] == 3
        assert storm["churning"] == "arg1.shape[1]"
        warns = [m for _l, m in log.cluster_msgs if "RECOMPILE_STORM" in m]
        assert len(warns) == 1 and "undeclared (rogue)" in warns[0]
        walls = [r for r in dw.first_launches()
                 if r["family"] == "gf256_matmul"
                 and r["sig"].endswith(("12289]", "12291]", "12293]"))]
        assert len(walls) == 3 and all(r["class"] == "rogue"
                                       and r["wall_s"] > 0 for r in walls)
    finally:
        (dw._log, dw._recent, dw._storm_last, dw.storm_min_rogue_sigs,
         dw.storm_window_s) = saved


def test_daemon_phase_on_the_card(dev):
    """The daemon phase's code at a small size on the card, on
    BlockStores as the phase runs: six daemons (isa k=4 m=2 over all six,
    a replicated pool), 1 MiB objects; each step's launches as the phase
    requires them, the offset writes' ranged sub-reads served from the
    stores' checksums at rest, the revival on a new BlockStore mounted
    from its directory, the rot refused by the read (K1 decodes around
    it), named by the scrub and healed by the repair, and every check of
    the phase."""
    import chip_smoke

    res = chip_smoke.run_daemon(
        torch, dev, n_osds=6, profile="plugin=isa k=4 m=2 "
        "technique=reed_sol_van", nobj=8, obj_bytes=1 << 20,
        stripe_bytes=256 << 10, rep_objs=4, rep_bytes=4096,
        overwrite=(2, 2), threads=4, pg_num=4)
    st = res["steps"]
    for name, need in (("warmup", ("gf256_matmul", "crc32c_rows",
                                   "crush_rule")),
                       ("write", ("gf256_matmul", "crc32c_rows")),
                       ("rmw", ("gf256_matmul",)),
                       ("read", ("gf256_matmul",)),
                       ("recover", ("gf256_matmul",)),
                       ("rot_read", ("gf256_matmul",)),
                       ("scrub", ("gf256_matmul",))):
        for x in need:
            assert st[name]["counts"][x] > 0, (name, x, st[name]["counts"])
    assert all(r["k6"] > 0 for r in res["refresh"])
    assert any(p.startswith("1.") for p, _ in st["recover"]["pulls"])
    assert st["rmw"]["extent_reads_at_rest"] > 0
    assert st["rmw"]["extent_reads_whole_chunk"] == 0
    assert st["rot_read"]["dec_jobs"] >= 1
    assert st["repair"]["post_errors"] == []


def test_cluster_phase_on_the_card(dev):
    """The cluster phase's code at a small size on the card: the port's
    RadosClient over six daemons (isa k=4 m=2 over all six, a replicated
    pool), 1 MiB objects; one ``_calc_target`` is one K6 launch, each
    step's launches as the phase requires them, and every check of the
    phase."""
    import chip_smoke

    res = chip_smoke.run_cluster(
        torch, dev, n_osds=6, profile="plugin=isa k=4 m=2 "
        "technique=reed_sol_van", nobj=8, obj_bytes=1 << 20,
        stripe_bytes=256 << 10, rep_objs=4, rep_bytes=4096, threads=4,
        pg_num=8, inflight=4, striped=(8 << 20, 256 << 10, 4, 1 << 20))
    st = res["steps"]
    assert res["k6_per_target"] == 1
    for name, need in (("write", ("gf256_matmul", "crc32c_rows",
                                  "crush_rule")),
                       ("failover", ("gf256_matmul", "crush_rule")),
                       ("read", ("gf256_matmul", "crush_rule")),
                       ("stripe", ("gf256_matmul", "crush_rule"))):
        for x in need:
            assert st[name]["counts"][x] > 0, (name, x, st[name]["counts"])
        assert st[name]["objecter_k6"] > 0
    assert st["failover"]["resent_ops"] >= 1


def test_vstart_phase_on_the_card(dev):
    """The vstart phase's code at a small size on the card: three port
    mons on LSMStores and six port daemons on BlockStores, an isa k=4 m=2
    pool made through the mons, 1 MiB objects written by the port's
    RadosClient; each step's launches as the phase requires them (the
    leader's relay walks K6, the mgr step's bench K1, the CRC and K6),
    and every check of the phase, the mgr's and the offline tools'."""
    import chip_smoke

    res = chip_smoke.run_vstart(
        torch, dev, n_osds=6, profile="plugin=isa k=4 m=2 "
        "technique=reed_sol_van", nobj=8, obj_bytes=1 << 20,
        stripe_bytes=256 << 10, threads=4)
    st = res["steps"]
    for name, need in (("pool", ("gf256_matmul", "crc32c_rows",
                                 "crush_rule")),
                       ("write", ("gf256_matmul", "crc32c_rows",
                                  "crush_rule")),
                       ("relay", ("gf256_matmul", "crush_rule")),
                       ("mgr", ("gf256_matmul", "crc32c_rows",
                                "crush_rule")),
                       ("leader_loss", ("gf256_matmul", "crc32c_rows")),
                       ("read", ("gf256_matmul", "crush_rule"))):
        for x in need:
            assert st[name]["counts"][x] > 0, (name, x, st[name]["counts"])
    assert st["relay"]["command_k6"] > 0
    assert st["mgr"]["bench"]["write"]["errors"] == 0
    assert st["monstore_tool"]["last_committed"] == \
        st["mon_restart"]["loaded_version"]
    assert st["read"]["dec_jobs"] >= st["read"]["lost_data_objects"] > 0
    assert st["mon_restart"]["last_committed"] == \
        st["mon_restart"]["leader_committed"]


def test_rados_cli_bench_on_the_card(dev):
    """The port's rados tool with no --device runs its cluster on the
    card: an isa k=2 m=1 pool and a one-second write bench, every op
    answered, K1 and the CRC kernel launched."""
    import contextlib
    import io

    from ceph_tpu_torch.tools import rados

    k1, crc = gf256.launches.value, cd.launches.value
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rados.main(["--vstart", "1x3", "--ec-profile",
                         "plugin=isa k=2 m=1", "--script",
                         "mkpool; bench 1 write"])
    out = buf.getvalue()
    assert rc == 0, out
    line = next(x for x in out.splitlines() if x.startswith("write: "))
    assert int(line.split()[1]) > 0 and line.endswith("errors 0"), line
    assert gf256.launches.value > k1 and cd.launches.value > crc


def test_objecter_cross_check_on_the_card_equals_the_cpu(dev, monkeypatch):
    """The objecter cross-check's sequence on port daemons and a client
    whose codecs, queue and map walk are on the card, held to the same
    sequence with ``device="cpu"``: the same replies, stores, logs,
    pg_stats and dump_scrubs after every step."""
    import time as _time

    import test_torch_daemon_xcheck as dx

    monkeypatch.setattr(_time, "time", lambda: dx.CLOCK)
    want = dx._client_sequence("ceph_tpu_torch")
    k6 = crush_rule.launches.value
    got = dx._client_sequence("ceph_tpu_torch", device=dev)
    assert crush_rule.launches.value > k6
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        for key in w:
            assert g[key] == w[key], (name, key)


def test_daemon_cluster_on_the_card_equals_the_cpu(dev, monkeypatch):
    """The daemon cross-check's sequence on port daemons whose codecs,
    queue and map walk are on the card, held to the same sequence with
    ``device="cpu"``: the same replies, stores, logs, pg_stats and
    dump_scrubs after every step; K1, the CRC kernel and K6 launch."""
    import time as _time

    import test_torch_daemon_xcheck as dx

    monkeypatch.setattr(_time, "time", lambda: dx.CLOCK)
    want = dx._sequence("ceph_tpu_torch")
    k1, crc, k6 = (gf256.launches.value, cd.launches.value,
                   crush_rule.launches.value)
    got = dx._sequence("ceph_tpu_torch", device=dev)
    assert gf256.launches.value > k1 and cd.launches.value > crc
    assert crush_rule.launches.value > k6
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        for key in w:
            assert g[key] == w[key], (name, key)



@pytest.mark.parametrize("k,m", [(8, 4), (5, 3)])
def test_clay_codec_on_the_card_equals_plain(dev, k, m):
    """Clay's encode, every single-shard repair and an m-erasure decode
    with the codec on the card (every product on K1, the gathers on the
    card) equal the same codec on the CPU (every product's plain
    version)."""
    from ceph_tpu_torch.ec.clay import ClayCodec

    card, plain = ClayCodec(k=k, m=m, device=dev), ClayCodec(
        k=k, m=m, device="cpu")
    s = 1000  # a per-sub-chunk width whose pair products are not ragged
    data = np.random.default_rng(k * 7 + m).integers(
        0, 256, (k, card.sub_count * s), dtype=np.uint8)
    before = gf256.launches.value
    parity = card.encode_array(data)
    assert gf256.launches.value > before
    np.testing.assert_array_equal(parity, plain.encode_array(data))
    chunks = list(data) + list(parity)
    for lost in range(k + m):
        helpers = {h: chunks[h] for h in range(k + m) if h != lost}
        np.testing.assert_array_equal(
            card.repair_chunk([lost], helpers)[lost], chunks[lost])
        erased = sorted({(lost + j) % (k + m) for j in range(m)})
        avail = {i: chunks[i] for i in range(k + m) if i not in erased}
        got = card.decode_array(avail, erased, card.sub_count * s)
        for e in erased:
            np.testing.assert_array_equal(got[e], chunks[e])
    assert card.products == gf256.launches.value - before


def test_clay_queue_kinds_on_the_card_equal_the_cpu(dev):
    """encp (coalesced, with per-shard CRCs on the CRC kernel), crep and
    cdec through the queue on the card equal the same jobs through the
    queue on the CPU."""
    from ceph_tpu_torch.ec.clay import ClayCodec

    out = {}
    for where in (dev, "cpu"):
        codec = ClayCodec(k=8, m=4, device=where)
        q = StripeBatchQueue(device=where, window_s=0.05)
        try:
            rng = np.random.default_rng(22)
            datas = [rng.integers(0, 256, (8, 64 * s), dtype=np.uint8)
                     for s in (512, 1000, 33)]
            futs = [q.encode_crc_async(codec, d) for d in datas]
            res = [f.result() for f in futs]
            chunks = list(datas[0]) + list(res[0][0])
            layers = codec.repair_layers(0)
            planes = np.stack([chunks[h].reshape(64, -1)[layers]
                               for h in range(1, 12)])
            rep = q.clay_repair(codec, 0, list(range(1, 12)), planes)
            dec = q.clay_decode_async(codec, {i: chunks[i] for i in
                                              range(12) if i not in
                                              (1, 5, 9)}).result()
            out[str(where)] = ([(c, [int(x) for x in cr]) for c, cr in res],
                               rep, dec)
            assert np.array_equal(rep, chunks[0])
            assert np.array_equal(dec, datas[0])
        finally:
            q.stop()
    card, cpu = out[str(dev)], out["cpu"]
    for (c1, r1), (c2, r2) in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(c1, c2)
        assert r1 == r2
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_array_equal(card[2], cpu[2])


def test_clay_phase_on_the_card(dev):
    """The clay phase's code at a small size on the card: clay k=8 m=4
    d=11, four 1 MiB objects; K1 in every step, the CRC kernel in the
    write, and every check of the phase."""
    import chip_smoke

    res = chip_smoke.run_clay(torch, dev, nobj=4, obj_bytes=1 << 20,
                              stripe_bytes=256 << 10, threads=4)
    st = res["steps"]
    for name in ("write", "repair", "read", "scrub"):
        assert st[name]["counts"]["gf256_matmul"] > 0, (name, st[name])
    assert st["write"]["counts"]["crc32c_rows"] > 0
    assert 0 < res["repair"]["frac_permille"] <= chip_smoke.CLAY_FRAC_MAX


def test_clay_daemon_cluster_on_the_card_equals_the_cpu(dev, monkeypatch):
    """The daemon cross-check's clay sequence (CLAY_POOL, clay k=4 m=2
    over six daemons) with codecs and queue on the card, held to the
    same sequence with ``device="cpu"``."""
    import time as _time

    import test_torch_daemon_xcheck as dx
    import torch_daemon_harness as H

    monkeypatch.setattr(_time, "time", lambda: dx.CLOCK)
    kw = {"pools": (H.CLAY_POOL,), "rewrite": False}
    want = dx._sequence("ceph_tpu_torch", **kw)
    k1 = gf256.launches.value
    got = dx._sequence("ceph_tpu_torch", device=dev, **kw)
    assert gf256.launches.value > k1
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        for key in w:
            assert g[key] == w[key], (name, key)


# -- K8: the mesh (gpu/meshio.py) and its digest kernel (csrc/meshio.cu) ----

@pytest.mark.parametrize("n", [1, 3, 4095, 1 << 20])
def test_mesh_digest_kernel_equals_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randint(0, 256, (12, n), dtype=torch.uint8, device=dev,
                      generator=g)
    before = mesh_digest.launches.value
    got = mesh_digest.mesh_digest(x)
    assert mesh_digest.launches.value == before + 1
    assert got.device == x.device and got.dtype == torch.int64
    assert torch.equal(got, mesh_digest.mesh_digest_plain(x))


def test_mesh_digest_kernel_on_pitched_column_slices(dev):
    """Column slices at every alignment (head and tail bytes of each row
    read apart from its 16-byte vectors), a one-row slice, the out=
    scratch, and a byte sum past 2^32 that wraps."""
    g = torch.Generator(device=dev).manual_seed(23)
    base = torch.randint(0, 256, (12, (1 << 16) + 37), dtype=torch.uint8,
                         device=dev, generator=g)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    for x in (base[:, 5:5 + 4099], base[3:9, 1:], base[:, 16:16 + 65536],
              base[:1, 7:8], base[:, 13:29], base[:, 3:3]):
        want = mesh_digest.mesh_digest_plain(x)
        assert torch.equal(mesh_digest.mesh_digest(x), want)
        assert torch.equal(mesh_digest.mesh_digest(x, out=out), want)
    ones = torch.full((12, 1 << 22), 255, dtype=torch.uint8, device=dev)
    assert 12 * (1 << 22) * 255 > 1 << 32
    assert torch.equal(mesh_digest.mesh_digest(ones),
                       mesh_digest.mesh_digest_plain(ones))


def test_mesh_on_the_card_equals_k1_alone(dev):
    """A 4 x 2 mesh on one card (``[dev] * 8``): the encode is one K1
    launch a cell (two coding rows each) and equals K1 over the whole
    batch, from a tensor and from numpy; the decode likewise; the digest
    is one launch a stripe row and equals a one-cell mesh's and the
    plain version's."""
    mesh = MeshCompute([dev] * 8)
    assert (mesh.dp, mesh.shard_par) == (4, 2)
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randint(0, 256, (8, (1 << 20) + 37), dtype=torch.uint8,
                      device=dev, generator=g)
    before = gf256.launches.value
    got = mesh.encode_scatter(codec.coding_u8, x, keep_device=True)
    assert gf256.launches.value - before == 8
    want = gf256.gf_matmul_bytes(codec.coding_u8, x)
    assert got.device == x.device and torch.equal(got, want)
    host = mesh.encode_scatter(codec.coding_u8, x.cpu().numpy())
    np.testing.assert_array_equal(host, want.cpu().numpy())
    survivors = [0, 1, 2, 3, 4, 5, 8, 9]
    rec, _ = codec.recovery_matrix(survivors)
    surv = torch.cat([x[:6], got[:2]])
    before = gf256.launches.value
    rebuilt = mesh.recovery_gather(rec, surv, keep_device=True)
    assert gf256.launches.value - before == 8
    assert torch.equal(rebuilt, x)
    assert torch.equal(rebuilt, gf256.gf_matmul_bytes(rec, surv))
    shards = torch.cat([x, got])
    before = mesh_digest.launches.value
    d = mesh.scrub_digest(shards)
    assert mesh_digest.launches.value - before == 4
    assert d == MeshCompute([dev]).scrub_digest(shards)
    assert d == int(mesh_digest.mesh_digest_plain(shards))
    assert d == mesh.scrub_digest(shards.cpu().numpy())


def test_mesh_queue_on_the_card(dev):
    """The queue's mesh route on the card: encp and dec batches ride a 4
    x 2 mesh and give the coding, CRCs and data of the queue without
    one."""
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    rng = np.random.default_rng(31)
    objs = [rng.integers(0, 256, (8, 128 << 10), dtype=np.uint8)
            for _ in range(8)]
    survivors = [0, 1, 2, 3, 4, 5, 8, 9]
    outs = []
    for mesh in (MeshCompute([dev] * 8), None):
        q = StripeBatchQueue(device=dev, mesh=mesh, window_s=0.005)
        try:
            enc = [f.result() for f in
                   [q.encode_crc_async(codec, o) for o in objs]]
            dec = [f.result() for f in [
                q.decode_data_async(codec, {
                    s: o[s] if s < 8 else c[s - 8] for s in survivors})
                for o, (c, _) in zip(objs, enc)]]
        finally:
            q.stop()
        assert q.mesh_batches == (q.batches if mesh else 0)
        outs.append((enc, dec))
    for (c1, r1), (c2, r2) in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(r1, r2)
    for o, d1, d2 in zip(objs, outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(d1, o)
        np.testing.assert_array_equal(d2, o)
