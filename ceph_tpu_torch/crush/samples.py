"""Small CRUSH maps and rules that reach every branch of the rule walk.

Each case is made by the port's own map constructors from fixed numbers (no
randomness but the ids, which the caller draws): every bucket algorithm,
flat and mixed hierarchies, firstn and indep, choose then chooseleaf,
reweighted and out devices, zero-weight items, ``choose_args`` weight
sets, the legacy tunables (local retries and the perm fallback),
``OP_SET_*`` steps, and numrep 0, negative and past the result width.
The CPU tests hold the plain walk against the reference package on
these maps; ``chip_smoke.py`` and the card tests hold the kernel against
the plain walk on them, at every budget.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.crush.map import (
    ALG_LIST,
    ALG_STRAW,
    ALG_STRAW2,
    ALG_TREE,
    ALG_UNIFORM,
    OP_CHOOSE_FIRSTN,
    OP_CHOOSE_INDEP,
    OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP,
    OP_EMIT,
    OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    OP_SET_CHOOSE_LOCAL_TRIES,
    OP_SET_CHOOSE_TRIES,
    OP_SET_CHOOSELEAF_STABLE,
    OP_SET_CHOOSELEAF_TRIES,
    OP_SET_CHOOSELEAF_VARY_R,
    OP_TAKE,
)

LEGACY_ALGS = (ALG_UNIFORM, ALG_LIST, ALG_TREE, ALG_STRAW)
_MIXED_W = [0x8000, 0x10000, 0x18000, 0x10000]


class Case(NamedTuple):
    name: str
    map: cmap.CrushMap
    steps: list
    result_max: int
    dev_weights: np.ndarray
    choose_args: Optional[Dict[int, List[int]]]
    oracle: str  # "native": straw2/uniform only; "reference": any alg


def _weights(n: int, out=(), half=()) -> np.ndarray:
    w = np.full(n, 0x10000, dtype=np.uint32)
    w[list(out)] = 0
    w[list(half)] = 0x8000
    return w


def _flat_legacy(alg: int, n: int):
    m = cmap.CrushMap()
    if alg == ALG_UNIFORM:
        w = [0x10000] * n
    else:
        w = ([0x8000, 0x10000, 0x18000, 0x10000, 0x20000, 0x10000]
             * 2)[:n]
    return m, m.add_bucket(alg, 10, list(range(n)), w)


def _mixed_hosts(root_alg: int = ALG_STRAW2):
    m = cmap.CrushMap()
    hosts = []
    for h, alg in enumerate((ALG_UNIFORM, ALG_LIST, ALG_TREE, ALG_STRAW,
                             ALG_STRAW2)):
        w = [0x10000] * 4 if alg == ALG_UNIFORM else _MIXED_W
        hosts.append(m.add_bucket(alg, 1, [h * 4 + i for i in range(4)], w))
    return m, m.add_bucket(root_alg, 10, hosts, [0x40000] * 5), hosts


def _hosts(n_hosts: int, per: int, host_alg: int = ALG_STRAW2,
           root_alg: int = ALG_STRAW2):
    m = cmap.CrushMap()
    hosts = [m.add_bucket(host_alg, 1, [h * per + i for i in range(per)],
                          [0x10000] * per) for h in range(n_hosts)]
    return m, m.add_bucket(root_alg, 10, hosts,
                           [0x10000 * per] * n_hosts), hosts


def _rule(root: int, *choose) -> list:
    return [(OP_TAKE, root, 0), *choose, (OP_EMIT, 0, 0)]


def cases() -> List[Case]:
    """Every small case, in a fixed order."""
    out: List[Case] = []

    def add(name, m, steps, r, dw=None, ca=None, oracle="native"):
        dw = _weights(m.max_devices) if dw is None else dw
        out.append(Case(name, m, steps, r, dw, ca, oracle))

    m, root = cmap.build_flat_cluster(32)
    add("flat_firstn_3", m, _rule(root, (OP_CHOOSE_FIRSTN, 3, 0)), 3)
    m, root = cmap.build_flat_cluster(24)
    add("flat_indep_6", m, _rule(root, (OP_CHOOSE_INDEP, 6, 0)), 6)
    m, root = cmap.build_flat_cluster(32, hosts=8)
    add("chooseleaf_firstn_3", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 3, 1)),
        3)
    m, root = cmap.build_flat_cluster(64, hosts=16)
    add("chooseleaf_indep_6", m, _rule(root, (OP_CHOOSELEAF_INDEP, 6, 1)),
        6)
    m, root = cmap.build_flat_cluster(64, hosts=8)
    add("choose_then_choose", m, _rule(
        root, (OP_CHOOSE_FIRSTN, 2, 1), (OP_CHOOSE_FIRSTN, 2, 0)), 4)
    add("choose_then_chooseleaf_indep", m, _rule(
        root, (OP_CHOOSE_INDEP, 2, 1), (OP_CHOOSELEAF_INDEP, 2, 0)), 4)
    m, root = cmap.build_flat_cluster(16)
    add("reweighted_out", m, _rule(root, (OP_CHOOSE_FIRSTN, 3, 0)), 3,
        _weights(16, out=(3, 11), half=(5,)))

    m = cmap.CrushMap()
    h1 = m.add_bucket(ALG_STRAW2, 1, [0, 1], [0x10000, 0x10000])
    h2 = m.add_bucket(ALG_STRAW2, 1, [2, 3], [0x10000, 0x10000])
    dead = m.add_bucket(ALG_STRAW2, 1, [4, 5], [0x10000, 0x10000])
    root = m.add_bucket(ALG_STRAW2, 10, [h1, h2, dead],
                        [0x20000, 0x20000, 0])
    add("zero_weight_host", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 2, 1)), 2)

    for alg in LEGACY_ALGS:
        m, root = _flat_legacy(alg, 12)
        add(f"alg{alg}_firstn", m, _rule(root, (OP_CHOOSE_FIRSTN, 3, 0)), 3,
            oracle="native" if alg == ALG_UNIFORM else "reference")
        m, root = _flat_legacy(alg, 8)
        add(f"alg{alg}_indep", m, _rule(root, (OP_CHOOSE_INDEP, 4, 0)), 4,
            oracle="native" if alg == ALG_UNIFORM else "reference")
    m = cmap.CrushMap()
    root = m.add_bucket(ALG_STRAW, 10, list(range(6)),
                        [0x10000, 0, 0x20000, 0x10000, 0, 0x8000])
    add("straw_zero_weights", m, _rule(root, (OP_CHOOSE_FIRSTN, 2, 0)), 2,
        oracle="reference")
    m = cmap.CrushMap()
    root = m.add_bucket(ALG_LIST, 10, list(range(10)), [0x10000] * 10)
    add("list_reweighted", m, _rule(root, (OP_CHOOSE_FIRSTN, 3, 0)), 3,
        _weights(10, out=(2,), half=(7,)), oracle="reference")
    m, root, _ = _mixed_hosts()
    add("mixed_hosts_firstn", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 3, 1)),
        3, _weights(20, out=(6,), half=(13,)), oracle="reference")
    add("mixed_hosts_indep", m, _rule(root, (OP_CHOOSELEAF_INDEP, 4, 1)), 4,
        oracle="reference")
    m, root, _ = _hosts(6, 3, root_alg=ALG_TREE)
    add("tree_root_indep", m, _rule(root, (OP_CHOOSELEAF_INDEP, 4, 1)), 4,
        oracle="reference")
    m, root, _ = _hosts(6, 4, host_alg=ALG_UNIFORM)
    dw = _weights(24, out=(5,), half=(9,))
    add("uniform_hosts_firstn", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 3, 1)),
        3, dw)
    add("uniform_hosts_indep", m, _rule(root, (OP_CHOOSELEAF_INDEP, 4, 1)),
        4, dw)

    m, root, hosts = _hosts(6, 4)
    ca = {root: [0x8000, 0x40000, 0x40000, 0x80000, 0x40000, 0x40000],
          hosts[1]: [0x10000, 0, 0x10000, 0x10000]}
    add("choose_args", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 3, 1)), 3,
        ca=ca, oracle="reference")

    m, root = cmap.build_flat_cluster(32, hosts=8)
    m.tunables = cmap.Tunables(
        choose_total_tries=19, choose_local_tries=2,
        choose_local_fallback_tries=5, chooseleaf_descend_once=0,
        chooseleaf_vary_r=0, chooseleaf_stable=0)
    dw = _weights(32, out=(1, 2, 3, 9), half=(17,))
    add("legacy_tunables_leaf", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 3, 1)),
        3, dw)
    add("legacy_tunables_osd", m, _rule(root, (OP_CHOOSE_FIRSTN, 4, 0)), 4,
        dw)

    m, root = cmap.build_flat_cluster(32, hosts=8)
    add("set_steps_firstn", m, [
        (OP_SET_CHOOSE_TRIES, 3, 0), (OP_SET_CHOOSELEAF_TRIES, 2, 0),
        (OP_SET_CHOOSE_LOCAL_TRIES, 1, 0),
        (OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES, 2, 0),
        (OP_SET_CHOOSELEAF_VARY_R, 0, 0), (OP_SET_CHOOSELEAF_STABLE, 0, 0),
        *_rule(root, (OP_CHOOSELEAF_FIRSTN, 3, 1))], 3, dw)
    add("set_steps_indep", m, [
        (OP_SET_CHOOSELEAF_TRIES, 3, 0), (OP_SET_CHOOSELEAF_VARY_R, 2, 0),
        *_rule(root, (OP_CHOOSELEAF_INDEP, 5, 1))], 5, dw)
    add("numrep_zero", m, _rule(root, (OP_CHOOSELEAF_FIRSTN, 0, 1)), 4, dw)
    add("numrep_negative", m, _rule(root, (OP_CHOOSELEAF_INDEP, -1, 1)), 5,
        dw)
    add("numrep_past_width", m, _rule(root, (OP_CHOOSELEAF_INDEP, 9, 1)), 5,
        dw)
    add("two_takes_two_emits", m, [
        *_rule(root, (OP_CHOOSELEAF_FIRSTN, 2, 1)),
        *_rule(-1, (OP_CHOOSE_FIRSTN, 2, 0))], 5, dw)
    add("chooseleaf_indep_type0", m, _rule(root, (OP_CHOOSELEAF_INDEP, 4, 0)),
        4, dw)
    return out


def case(name: str) -> Case:
    for c in cases():
        if c.name == name:
            return c
    raise KeyError(name)


def ids(seed: int, n: int) -> np.ndarray:
    """Seeded int32 object ids over the whole positive range."""
    return np.random.default_rng(seed).integers(
        0, 2 ** 31 - 1, n).astype(np.int32)

