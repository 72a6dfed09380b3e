"""The port's rule walk held against the JAX package's compile_rule on the
CPU, bit for bit, where the native oracle does not reach: the legacy
bucket algorithms (list, tree, straw; uniform too) of
tests/test_crush_legacy_algs.py, which skip here without
``libcrush_ref.so``, and ``choose_args`` weight sets.  Each case is
carried into the reference as arrays of the port's map, so both walk
one map.  (tests/test_torch_crush_mapper.py holds the budgets' clean
sets against the reference.)"""

import dataclasses

import numpy as np
import pytest

from ceph_tpu.crush import map as ref_map
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu_torch.crush import mapper, samples

# mixed_hosts_indep (a uniform, a list, a tree and a straw host under
# chooseleaf indep) is left to the card tests: its JAX compile alone takes
# 30-100 s here, and each of its parts is held below in another case
REFERENCE = [c.name for c in samples.cases()
             if c.oracle == "reference" and c.name != "mixed_hosts_indep"]


def _ref_flat(flat):
    fields = {f.name: getattr(flat, f.name)
              for f in dataclasses.fields(flat) if f.name != "tunables"}
    return ref_map.FlatMap(tunables=ref_map.Tunables(
        **dataclasses.asdict(flat.tunables)), **fields)


def _case(name, n):
    case = samples.case(name)
    flat = case.map.flatten()
    return case, flat, _ref_flat(flat), samples.ids(13, n)


@pytest.mark.parametrize("name", REFERENCE)
def test_sample_walk_matches_reference(name):
    case, flat, rflat, xs = _case(name, 256)
    want = np.asarray(ref_mapper.compile_rule(
        rflat, case.steps, case.result_max,
        choose_args=case.choose_args)(xs, case.dev_weights))
    got = mapper.compile_rule(flat, case.steps, case.result_max,
                              choose_args=case.choose_args,
                              device="cpu")(xs, case.dev_weights)
    np.testing.assert_array_equal(got.numpy(), want)


def test_choose_args_change_placement():
    case, flat, _, xs = _case("choose_args", 400)
    base = mapper.compile_rule(flat, case.steps, 3, device="cpu")(
        xs, case.dev_weights)
    over = mapper.compile_rule(flat, case.steps, 3,
                               choose_args=case.choose_args,
                               device="cpu")(xs, case.dev_weights)
    assert not np.array_equal(base.numpy(), over.numpy())
    # the weight set zeroes one osd of host 1 (items 4..7)
    assert not np.isin(over.numpy(), [5]).any()
