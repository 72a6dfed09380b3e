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
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.ops import crc32c_device as cd
from ceph_tpu_torch.ops import benchloop, crush_rule, gf2_matmul, gf256
from ceph_tpu_torch.ops import gf256_planes
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
