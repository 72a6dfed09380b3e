"""The hash-order rule of the port's straw2 scan, mirroring
tests/test_crush_fastcmp.py on the CPU.

The kernel (csrc/crush.cu) settles a straw2 item against the running
leader by its hash alone when both share one weight w <= fastcmp_bounds()[2]
and their hashes differ by at least 2; everything else takes the exact
draw, whose quotient is a multiply by a reciprocal.  These tests pin:

- ``fastcmp_bounds`` against the reference's derivation;
- the rule itself, exhaustively over the 65536-entry ln table: at every
  hash distance >= 2 and the weights 1, 0x10000, 0x100000 and the bound,
  draw order is hash order (and at distance 1 it is not);
- ``straw2_scan_plain`` (the kernel's leader scan as PyTorch ops) against
  the exact straw2 choose on crafted and seeded rows;
- ``recip_div_plain`` (the kernel's reciprocal divide) against ``//``;
- ``sweep`` and ``sweep_device`` on the CPU against ``_native.do_rule``
  and the reference's staged ``sweep_device``, with a choose_args weight
  profile that makes the weights unequal.

Reference: bucket_straw2_choose, src/crush/mapper.c:361-384.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ceph_tpu import _native
from ceph_tpu.crush import ln as ref_ln
from ceph_tpu.crush import map as ref_map
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu_torch.crush import ln, mapper, samples
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.ops import crush_rule

B = ln.fastcmp_bounds()[2]
U16 = np.arange(0x10000, dtype=np.int64)


def test_fastcmp_bounds_equal_the_reference_derivation():
    assert ln.fastcmp_bounds() == ref_ln.fastcmp_bounds()
    n = -ln.ln16_table()
    sm = np.maximum.accumulate(n[::-1])[::-1]
    for d, b in ln.fastcmp_bounds().items():
        assert b == int((n[:-d] - sm[d:]).min()) > 0
    assert B > 1 << 24
    assert B < ln.fastcmp_bounds()[3] < ln.fastcmp_bounds()[4]


@pytest.mark.parametrize("w", [1, 0x10000, 0x100000, B])
def test_hash_order_is_draw_order_at_distance_two(w):
    """For every pair u < v with v - u >= 2, draw(v) > draw(u): each
    draw beats the running maximum of the draws two and more below it."""
    d = ln.straw2_draw(U16, np.full_like(U16, w))
    np.testing.assert_array_equal(d, ref_ln.straw2_draw(U16, np.full_like(
        U16, w)))
    assert (d[2:] > np.maximum.accumulate(d)[:-2]).all()


def test_hash_order_is_not_draw_order_at_distance_one():
    """The ln table inverts between neighbours: the scan's exact window."""
    d = ln.straw2_draw(U16, np.ones_like(U16))
    assert (d[1:] <= d[:-1]).any()


def _exact_choose(u, w):
    """mapper.c's straw2 choose: the first index of the greatest draw."""
    return ref_ln.straw2_draw(u, w).argmax(axis=1)


def _scan(u, w, fast_max=None):
    hi, exact = crush_rule.straw2_scan_plain(
        torch.from_numpy(np.asarray(u, dtype=np.int64)),
        torch.from_numpy(np.asarray(w, dtype=np.int64)), fast_max)
    return hi.numpy(), exact.numpy()


def _coarse_tie():
    """Two hashes 2 apart whose draws are equal at weight 2^31 (past the
    bound, the quotient is too coarse for the hash order)."""
    d = ln.straw2_draw(U16, np.full_like(U16, 1 << 31))
    u = int(np.nonzero(d[2:] == d[:-2])[0][0])
    return u, u + 2


def test_straw2_scan_equals_the_exact_choose_on_crafted_rows():
    lo, hi = _coarse_tie()
    W, Z, BIG = 0x10000, 0, 1 << 31
    rows = [
        ([500, 500, 500, 500], [W] * 4),             # equal hashes: first
        ([100, 101, 99, 100], [W] * 4),              # neighbours
        ([9, 3000, 3001, 2999], [W] * 4),
        ([7000, 5, 6, 65535], [Z, W, W, Z]),         # zero weights
        ([7000, 5, 6, 40000], [Z, Z, Z, Z]),         # all zero: item 0
        ([40000, 5, 6, 7], [Z, W, W, W]),
        ([60000, 60002, 50000, 60001], [W, 2 * W, W, 3 * W]),  # unequal
        ([lo, hi, lo, 3], [BIG] * 4),                # w > B, equal draws
        ([1000, 1004, 1002, 999], [B + 1] * 4),
        ([1000, 1004, 1002, 999], [B] * 4),
        ([1000, 1004, 1002, 999], [B, B, B + 1, B]),
    ]
    u = np.array([r[0] for r in rows])
    w = np.array([r[1] for r in rows])
    got, exact = _scan(u, w)
    np.testing.assert_array_equal(got, _exact_choose(u, w))
    # past the bound the hash order would pick the higher hash: wrong
    assert got[7] == 0
    # equal weights under the bound, hashes 2 and more apart: no exact draw
    assert exact[2] == 1 and exact[9] == 0 and exact[0] == 0
    assert exact[4] == 0 and exact[6] == 3


def test_straw2_scan_equals_the_exact_choose_on_seeded_rows():
    rng = np.random.default_rng(12)
    L, S = 20000, 12
    u = rng.integers(0, 0x10000, (L, S))
    near = rng.random((L, S)) < 0.5  # hashes within 2 of item 0's
    u = np.where(near, np.clip(u[:, :1] + rng.integers(-2, 3, (L, S)), 0,
                               0xFFFF), u)
    w = rng.choice([0, 1, 0x10000, 0x20000, B, B + 1, 1 << 31], (L, S),
                   p=[0.1, 0.05, 0.4, 0.15, 0.1, 0.1, 0.1])
    got, exact = _scan(u, w)
    np.testing.assert_array_equal(got, _exact_choose(u, w))
    assert 0 < exact.sum() < L * (S - 1)
    # one weight under the bound: only distance-1 pairs go exact
    u1 = rng.integers(0, 0x10000, (L, S))
    got, exact = _scan(u1, np.full_like(u1, 0x10000))
    np.testing.assert_array_equal(got, _exact_choose(
        u1, np.full_like(u1, 0x10000)))
    assert exact.sum() < L // 100
    # with the hash order off every comparison is exact, and still right
    got, exact = _scan(u, w, fast_max=0)
    np.testing.assert_array_equal(got, _exact_choose(u, w))


EDGE_W = sorted({1, 2, 0xFFFF, 0x10000, (1 << 32) - 1}
                | {(1 << k) + d for k in range(1, 32) for d in (-1, 0, 1)})


def _recip(mag, w):
    w = np.asarray(w, dtype=np.int64)
    return crush_rule.recip_div_plain(
        torch.from_numpy(np.asarray(mag, dtype=np.int64)),
        torch.from_numpy(w), torch.from_numpy(crush_rule.recip_magic(w))
    ).numpy()


def test_recip_div_equals_floor_division_on_edge_weights():
    for mag in (0, 1, 2, (1 << 48) - 1, 1 << 48):
        w = np.array(EDGE_W, dtype=np.int64)
        np.testing.assert_array_equal(_recip(np.full_like(w, mag), w),
                                      mag // w)
    w = np.array(EDGE_W * 64, dtype=np.int64)
    mag = np.random.default_rng(3).integers(0, (1 << 48) + 1, w.size)
    np.testing.assert_array_equal(_recip(mag, w), mag // w)


def test_recip_div_equals_floor_division_on_seeded_pairs():
    rng = np.random.default_rng(4)
    mag = rng.integers(1, (1 << 48) + 1, 100_000)
    w = rng.integers(1, 1 << 32, 100_000)
    np.testing.assert_array_equal(_recip(mag, w), mag // w)
    # the ln magnitudes the kernel divides, at the straw2 weights
    n = -ln.ln16_table()
    for wt in (0x10000, 0x20000, B, B + 1):
        np.testing.assert_array_equal(_recip(n, np.full_like(n, wt)),
                                      n // wt)


# -- the staged sweeps against the native oracle and the reference ------------

def _cluster(profile):
    """tests/test_torch_crush_mapper.py's _cluster map (64 OSDs, 8 hosts,
    chooseleaf firstn 3), and a choose_args weight set for the root and
    two hosts that makes their weights unequal."""
    m, root = cmap.build_flat_cluster(64, hosts=8)
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
             (cmap.OP_EMIT, 0, 0)]
    ca = None
    if profile == "choose_args":
        ca = {root: [0x80000, 0x100000, 0x60000, 0x80000, 0xA0000,
                     0x80000, 0x40000, 0x80000],
              -1: [0x10000, 0x20000, 0x10000, 0x8000, 0x10000, 0x10000,
                   0x18000, 0x10000],
              -2: [B, B, B + 1, B, 0x10000, B, B, 0]}
    return m.flatten(), steps, ca


def _with_choose_args(flat, ca):
    """The flat map with the choose_args weights put in place: the native
    oracle takes no weight set."""
    w = np.array(flat.weights, dtype=np.uint32)
    for bid, ws in (ca or {}).items():
        w[-1 - bid, :len(ws)] = ws
    return dataclasses.replace(flat, weights=w)


def _oracle(flat, steps, xs, dev_w):
    out = np.full((len(xs), 3), cmap.ITEM_NONE, dtype=np.int32)
    st = np.asarray(steps, dtype=np.int32).ravel()
    for i, x in enumerate(xs):
        r = _native.do_rule(flat, st, int(x), 3, dev_w)
        out[i, :len(r)] = r
    return out


def _ref_flat(flat):
    fields = {f.name: getattr(flat, f.name)
              for f in dataclasses.fields(flat) if f.name != "tunables"}
    return ref_map.FlatMap(tunables=ref_map.Tunables(
        **dataclasses.asdict(flat.tunables)), **fields)


@pytest.mark.parametrize("profile", ["uniform", "choose_args"])
def test_sweeps_equal_native_oracle_and_reference_sweep_device(profile):
    flat, steps, ca = _cluster(profile)
    dev_w = np.full(64, 0x10000, dtype=np.uint32)
    dev_w[5], dev_w[17], dev_w[40] = 0, 0x4000, 0
    xs = np.arange(2048, dtype=np.int32)
    want = _oracle(_with_choose_args(flat, ca), steps, xs, dev_w)
    host = mapper.sweep(flat, steps, 3, xs, dev_w, choose_args=ca,
                        chunk=512, device="cpu")
    np.testing.assert_array_equal(host, want)
    got, overflow = mapper.sweep_device(flat, steps, 3, xs, dev_w,
                                        choose_args=ca, chunk=512,
                                        bad_div=2, bad2_div=4, device="cpu")
    assert not bool(overflow)
    np.testing.assert_array_equal(got.numpy(), want)
    ref, ref_overflow = ref_mapper.sweep_device(
        _ref_flat(flat), steps, 3, xs, dev_w, choose_args=ca, chunk=512,
        bad_div=1, bad2_div=1)
    assert not bool(ref_overflow)
    np.testing.assert_array_equal(np.asarray(ref), want)
    if profile == "choose_args":  # the weight set moved placements
        plain = _oracle(flat, steps, xs, dev_w)
        assert (plain != want).any()


def test_sample_map_of_weight_classes_reaches_every_scan_rule():
    """``samples``' straw2_weight_classes case: its host rows, scanned at
    seeded hashes, take both the hash order and the exact draw."""
    case = samples.case("straw2_weight_classes")
    flat = case.map.flatten()
    rows = [b for b in range(len(flat.sizes)) if flat.types[b] == 1]
    w = np.asarray(flat.weights, dtype=np.int64)[rows, :8]
    u = np.random.default_rng(9).integers(0, 0x10000, (4000, len(rows), 8))
    u = u.reshape(-1, 8)
    w = np.tile(w, (4000, 1))
    got, exact = _scan(u, w)
    np.testing.assert_array_equal(got, _exact_choose(u, w))
    assert 0 < exact.sum() < 7 * len(u)
