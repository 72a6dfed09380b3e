"""The port's rule walk and staged sweeps held against the native scalar
oracle (``_native.do_rule``, csrc/crush_oracle.cc) on the CPU, bit for
bit, mirroring tests/test_crush_mapper.py, tests/test_sweep_device.py and
the staged-sweep cases of tests/test_crush_fastcmp.py at tier-1 sizes:
every straw2 and uniform case of ``crush.samples`` (flat and
hierarchical, firstn and indep, reweighted and out devices, zero-weight
items, the legacy tunables' local retries and perm fallback, ``OP_SET_*``
steps), the budgets' clean rows, ``sweep`` and ``sweep_device`` and its
overflow flag.  The budgets' clean sets are also held against the JAX
package's ``one_shot`` / ``budget`` programs: every id the reference
calls clean the port calls clean, with the reference's row, and every
row the port calls clean is the full walk's."""

import dataclasses

import numpy as np
import pytest
import torch

from ceph_tpu import _native
from ceph_tpu.crush import map as ref_map
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.crush import mapper, samples
from ceph_tpu_torch.ops import crush_rule

NATIVE = [c.name for c in samples.cases() if c.oracle == "native"]


def _oracle(flat, steps, xs, result_max, dev_w):
    out = np.full((len(xs), result_max), cmap.ITEM_NONE, dtype=np.int32)
    st = np.asarray(steps, dtype=np.int32).ravel()
    for i, x in enumerate(xs):
        r = _native.do_rule(flat, st, int(x), result_max, dev_w)
        out[i, :len(r)] = r
    return out


def _run(flat, steps, result_max, xs, dev_w, **kw):
    got = mapper.compile_rule(flat, steps, result_max, device="cpu",
                              **kw)(xs, dev_w)
    if isinstance(got, tuple):
        return tuple(t.numpy() for t in got)
    return got.numpy()


def _compare(m, steps, result_max, n=256, dev_w=None, seed=0):
    flat = m.flatten()
    dev_w = (np.full(flat.max_devices, 0x10000, dtype=np.uint32)
             if dev_w is None else dev_w)
    xs = samples.ids(seed, n)
    got = _run(flat, steps, result_max, xs, dev_w)
    assert got.dtype == np.int32 and got.shape == (n, result_max)
    np.testing.assert_array_equal(got, _oracle(flat, steps, xs, result_max,
                                               dev_w))
    return got


# -- tests/test_crush_mapper.py ----------------------------------------------

def test_flat_firstn_replica3():
    m, root = cmap.build_flat_cluster(32)
    got = _compare(m, [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSE_FIRSTN, 3, 0),
                       (cmap.OP_EMIT, 0, 0)], 3)
    assert ((got >= 0) & (got < 32)).all()
    assert all(len(set(row.tolist())) == 3 for row in got)


def test_flat_indep_ec():
    m, root = cmap.build_flat_cluster(24)
    got = _compare(m, [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSE_INDEP, 6, 0),
                       (cmap.OP_EMIT, 0, 0)], 6)
    assert ((got >= 0) & (got < 24)).all()


def test_hierarchical_chooseleaf_firstn():
    m, root = cmap.build_flat_cluster(32, hosts=8)
    got = _compare(m, [(cmap.OP_TAKE, root, 0),
                       (cmap.OP_CHOOSELEAF_FIRSTN, 3, 1),
                       (cmap.OP_EMIT, 0, 0)], 3)
    assert all(len({int(v) // 4 for v in row}) == 3 for row in got)


def test_hierarchical_chooseleaf_indep():
    m, root = cmap.build_flat_cluster(64, hosts=16)
    _compare(m, [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_INDEP, 6, 1),
                 (cmap.OP_EMIT, 0, 0)], 6)


def test_two_level_choose_then_chooseleaf():
    m, root = cmap.build_flat_cluster(64, hosts=8)
    _compare(m, [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSE_FIRSTN, 2, 1),
                 (cmap.OP_CHOOSE_FIRSTN, 2, 0), (cmap.OP_EMIT, 0, 0)], 4,
             n=128)


def test_reweighted_and_out_devices():
    m, root = cmap.build_flat_cluster(16)
    dev_w = np.full(16, 0x10000, dtype=np.uint32)
    dev_w[3], dev_w[5], dev_w[11] = 0, 0x8000, 0
    got = _compare(m, [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSE_FIRSTN, 3, 0),
                       (cmap.OP_EMIT, 0, 0)], 3, dev_w=dev_w, n=512)
    assert not np.isin(got, [3, 11]).any()


def test_zero_weight_bucket_items():
    case = samples.case("zero_weight_host")
    got = _compare(case.map, case.steps, case.result_max)
    assert not np.isin(got, [4, 5]).any()


def test_distribution_tracks_weights():
    m = cmap.CrushMap()
    root = m.add_bucket(cmap.ALG_STRAW2, 10, [0, 1, 2, 3],
                        [0x10000, 0x20000, 0x30000, 0x40000])
    got = _run(m.flatten(), [(cmap.OP_TAKE, root, 0),
                             (cmap.OP_CHOOSE_FIRSTN, 1, 0),
                             (cmap.OP_EMIT, 0, 0)], 1,
               np.arange(40000, dtype=np.int32),
               np.full(4, 0x10000, dtype=np.uint32)).ravel()
    frac = np.bincount(got, minlength=4) / got.size
    np.testing.assert_allclose(frac, np.array([1, 2, 3, 4]) / 10.0,
                               atol=0.02)


def test_uniform_bucket_places():
    m = cmap.CrushMap()
    root = m.add_bucket(cmap.ALG_UNIFORM, 10, [0, 1, 2], [0x10000] * 3)
    got = _compare(m, [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSE_FIRSTN, 1, 0),
                       (cmap.OP_EMIT, 0, 0)], 1, n=64)
    assert set(np.unique(got)) <= {0, 1, 2}


# -- every straw2 / uniform sample, at every budget ---------------------------

@pytest.mark.parametrize("name", NATIVE)
def test_sample_walk_and_budgets_match_native_oracle(name):
    case = samples.case(name)
    flat = case.map.flatten()
    xs = samples.ids(11, 256)
    want = _oracle(flat, case.steps, xs, case.result_max, case.dev_weights)
    got = _run(flat, case.steps, case.result_max, xs, case.dev_weights)
    np.testing.assert_array_equal(got, want)
    for kw in ({"one_shot": True}, {"one_shot": True, "budget": 3},
               {"budget": 1 << 20}):
        res, clean = _run(flat, case.steps, case.result_max, xs,
                          case.dev_weights, **kw)
        assert clean.dtype == np.bool_ and clean.shape == (256,)
        # a clean row is the full walk's row
        np.testing.assert_array_equal(res[clean], want[clean])
    # a budget past every try refuses nothing
    assert clean.all()


# -- the wrapper's contract on the CPU ----------------------------------------

def test_launch_lane_lists_and_append_buffer():
    case = samples.case("chooseleaf_firstn_3")
    flat = case.map.flatten()
    rm = mapper.device_map(flat, device="cpu")
    spec = crush_rule.RuleSpec(case.steps, case.result_max)
    dev_w = np.full(32, 0x10000, dtype=np.uint32)
    dev_w[[3, 7, 20]] = 0
    w = torch.from_numpy(dev_w.view(np.int32))
    xs = torch.from_numpy(samples.ids(2, 300))
    out = torch.full((300, 3), -5, dtype=torch.int32)
    bad = torch.full((16,), -1, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    crush_rule.launch(rm, spec, w, xs, out, budget=1, bad=bad,
                      bad_count=count, idx_base=1000)
    full, clean = crush_rule.rule_plain(rm, spec, w, xs, 1)
    unclean = torch.nonzero(~clean).squeeze(1).to(torch.int32)
    assert int(count[0]) == unclean.numel() > 16  # counts past capacity
    assert torch.equal(bad, unclean[:16] + 1000)
    assert torch.equal(out, full)
    # walk only the listed ids, as many as the count says
    lanes = torch.tensor([5, 9, 250, 0], dtype=torch.int32)
    out2 = torch.full((300, 3), -5, dtype=torch.int32)
    crush_rule.launch(rm, spec, w, xs, out2, lanes=lanes,
                      lane_count=torch.tensor([3], dtype=torch.int32))
    exact, _ = crush_rule.rule_plain(rm, spec, w, xs, 0)
    walked = [5, 9, 250]
    assert torch.equal(out2[walked], exact[walked])
    assert (out2[[0, 1, 299]] == -5).all()
    with pytest.raises(ValueError):
        crush_rule.RuleSpec(case.steps, crush_rule.MAX_RESULT + 1)
    with pytest.raises(ValueError):
        crush_rule.launch(rm, spec, w, xs, out[:, :2])


# -- tests/test_sweep_device.py and the staged sweeps -------------------------

def _cluster(n_osds=64, hosts=8, nrep=3):
    m, root = cmap.build_flat_cluster(n_osds, hosts=hosts)
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSELEAF_FIRSTN, nrep, 1),
             (cmap.OP_EMIT, 0, 0)]
    return m.flatten(), steps, nrep


def test_sweep_device_matches_host_sweep():
    flat, steps, nrep = _cluster()
    dev_w = np.full(64, 0x10000, dtype=np.uint32)
    dev_w[5], dev_w[17], dev_w[40] = 0, 0x4000, 0
    xs = np.arange(4096, dtype=np.int32)
    want = _oracle(flat, steps, xs, nrep, dev_w)
    host = mapper.sweep(flat, steps, nrep, xs, dev_w, chunk=1024,
                        device="cpu")
    np.testing.assert_array_equal(host, want)
    got, overflow = mapper.sweep_device(flat, steps, nrep, xs, dev_w,
                                        chunk=1024, bad_div=2, device="cpu")
    assert not bool(overflow)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_device_overflow_flag():
    flat, steps, nrep = _cluster()
    dev_w = np.zeros(64, dtype=np.uint32)
    dev_w[:4] = 0x10000  # nearly everything rejected -> heavy retries
    xs = np.arange(1024, dtype=np.int32)
    _, overflow = mapper.sweep_device(flat, steps, nrep, xs, dev_w,
                                      chunk=1024, bad_div=256, device="cpu")
    assert bool(overflow)
    # the same sweep at full capacity does not overflow, and is exact
    got, overflow = mapper.sweep_device(flat, steps, nrep, xs, dev_w,
                                        chunk=1024, bad_div=1, bad2_div=1,
                                        device="cpu")
    assert not bool(overflow)
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle(flat, steps, xs, nrep, dev_w))
    # the stage-1 capacity is sweep-wide, n // bad_div: with the ids that
    # one attempt leaves unclean put first, the first of 4 chunks holds
    # more of them than chunk // bad_div, and the flag still fires only
    # when the whole sweep's count passes n // bad_div
    dev_w = np.full(64, 0x10000, dtype=np.uint32)
    dev_w[5], dev_w[17], dev_w[40] = 0, 0x4000, 0
    clean = mapper.compile_rule(flat, steps, nrep, one_shot=True,
                                device="cpu")(xs, dev_w)[1].numpy()
    xs = np.concatenate([xs[~clean], xs[clean]])
    unclean = int((~clean).sum())
    k = 1024 // unclean
    assert unclean > 256 // k
    for bad_div, want in ((k, False), (k + 1, True)):
        _, overflow = mapper.sweep_device(flat, steps, nrep, xs, dev_w,
                                          chunk=256, bad_div=bad_div,
                                          bad2_div=1, device="cpu")
        assert bool(overflow) == want
    np.testing.assert_array_equal(
        mapper.sweep_device(flat, steps, nrep, xs, dev_w, chunk=256,
                            bad_div=k, bad2_div=1, device="cpu")[0].numpy(),
        _oracle(flat, steps, xs, nrep, dev_w))


def test_sweep_device_single_chunk_whole_batch():
    flat, steps, nrep = _cluster(n_osds=32, hosts=4)
    dev_w = np.full(32, 0x10000, dtype=np.uint32)
    xs = np.arange(2048, dtype=np.int32)
    got, overflow = mapper.sweep_device(flat, steps, nrep, xs, dev_w,
                                        bad_div=1, bad2_div=1, device="cpu")
    assert not bool(overflow)
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle(flat, steps, xs, nrep, dev_w))
    with pytest.raises(ValueError):
        mapper.sweep_device(flat, steps, nrep, xs[:1000], dev_w, chunk=512,
                            device="cpu")


@pytest.mark.parametrize("mixed", [False, True])
def test_staged_sweep_exact_vs_full_program(mixed):
    """test_crush_fastcmp.py's staged-sweep cases (uniform and mixed
    weights), at a tier-1 size and a ragged last chunk."""
    flat, steps, _ = _cluster()
    if mixed:
        w = np.asarray(flat.weights).copy()
        rng = np.random.default_rng(7)
        for b in range(w.shape[0]):
            sz = int(flat.sizes[b])
            w[b, :sz] = (w[b, :sz].astype(np.uint64)
                         * rng.integers(1, 5, sz)).astype(w.dtype)
        flat = dataclasses.replace(flat, weights=w)
    dev_w = np.full(64, 0x10000, dtype=np.uint32)
    dev_w[7], dev_w[12] = 0, 0x8000
    xs = np.arange(3000, dtype=np.int32)
    want = _run(flat, steps, 3, xs, dev_w)
    np.testing.assert_array_equal(
        want[::50], _oracle(flat, steps, xs[::50], 3, dev_w))
    got = mapper.sweep(flat, steps, 3, xs, dev_w, chunk=1024, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert mapper.sweep(flat, steps, 3, xs[:0], dev_w,
                        device="cpu").shape == (0, 3)


def test_compiled_rules_and_maps_are_cached_by_content():
    flat, steps, nrep = _cluster()
    a = mapper.compile_rule(flat, steps, nrep, device="cpu")
    flat2 = dataclasses.replace(flat, items=flat.items.copy())
    assert mapper.compile_rule(flat2, steps, nrep, device="cpu") is a
    assert mapper.compile_rule(flat, steps, nrep, one_shot=True,
                               device="cpu") is not a
    assert mapper.device_map(flat, device="cpu") is a.rm


# -- the budgets' clean sets against the reference package --------------------

def _ref_flat(flat):
    fields = {f.name: getattr(flat, f.name)
              for f in dataclasses.fields(flat) if f.name != "tunables"}
    return ref_map.FlatMap(tunables=ref_map.Tunables(
        **dataclasses.asdict(flat.tunables)), **fields)


def _case(name, n):
    case = samples.case(name)
    flat = case.map.flatten()
    return case, flat, _ref_flat(flat), samples.ids(13, n)


@pytest.mark.parametrize("name,budget", [("choose_args", 1),
                                         ("choose_args", 3),
                                         ("chooseleaf_firstn_3", 3)])
def test_budget_clean_sets_against_reference(name, budget):
    case, flat, rflat, xs = _case(name, 200)
    ca = case.choose_args
    kw = {"one_shot": True, "budget": None if budget == 1 else budget}
    full = np.asarray(ref_mapper.compile_rule(
        rflat, case.steps, case.result_max, choose_args=ca)(
            xs, case.dev_weights))
    rres, rclean = (np.asarray(v) for v in ref_mapper.compile_rule(
        rflat, case.steps, case.result_max, choose_args=ca, **kw)(
            xs, case.dev_weights))
    res, clean = (t.numpy() for t in mapper.compile_rule(
        flat, case.steps, case.result_max, choose_args=ca, device="cpu",
        **kw)(xs, case.dev_weights))
    assert clean[rclean].all()  # the port's unclean set is a subset
    np.testing.assert_array_equal(res[rclean], rres[rclean])
    np.testing.assert_array_equal(res[clean], full[clean])
    assert 0 < clean.sum() < len(xs)
