"""CrushMap — host-side map construction and the flattened device layout.

The port's copy of ``ceph_tpu/crush/map.py``, with
:func:`flatmap_from_arrays` added to carry a map across from the
reference's ``FlatMap`` arrays.  It plays the role of CrushWrapper and
Ceph's bucket construction (reference: src/crush/CrushWrapper.h:796-1517
mutation/query API, crush_make_*_bucket) with a fresh design: buckets
are python objects, and ``flatten()`` lowers the map to dense padded
arrays — the layout
consumed by the rule walk (``ceph_tpu_torch.crush.mapper``: its CUDA
kernel ``csrc/crush.cu`` and its plain PyTorch version).

Bucket ids follow the reference convention: devices are >= 0, buckets
are negative, bucket id b lives at flat index -1-b.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# bucket algorithms (reference: src/crush/crush.h crush_algorithm)
ALG_UNIFORM = 1
ALG_LIST = 2
ALG_TREE = 3
ALG_STRAW = 4
ALG_STRAW2 = 5

# rule step ops (reference: src/crush/crush.h crush_opcodes)
OP_NOOP = 0
OP_TAKE = 1
OP_CHOOSE_FIRSTN = 2
OP_CHOOSE_INDEP = 3
OP_EMIT = 4
OP_CHOOSELEAF_FIRSTN = 6
OP_CHOOSELEAF_INDEP = 7
OP_SET_CHOOSE_TRIES = 8
OP_SET_CHOOSELEAF_TRIES = 9
OP_SET_CHOOSE_LOCAL_TRIES = 10
OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
OP_SET_CHOOSELEAF_VARY_R = 12
OP_SET_CHOOSELEAF_STABLE = 13

ITEM_UNDEF = 0x7FFFFFFE
ITEM_NONE = 0x7FFFFFFF


@dataclasses.dataclass
class Tunables:
    """Modern ("jewel"/optimal) defaults, matching the reference's
    current profile (reference: src/crush/CrushWrapper.h set_tunables_*)."""

    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1  # original-straw scaling formula rev


@dataclasses.dataclass
class Bucket:
    id: int  # negative
    alg: int
    type: int
    items: List[int] = dataclasses.field(default_factory=list)
    weights: List[int] = dataclasses.field(default_factory=list)  # 16.16

    @property
    def weight(self) -> int:
        return sum(self.weights)


@dataclasses.dataclass
class Rule:
    name: str
    steps: List[Tuple[int, int, int]]  # (op, arg1, arg2)
    ruleset: int = 0
    type: int = 1  # replicated=1, erasure=3 (pg_pool_t convention)
    min_size: int = 1
    max_size: int = 32


@dataclasses.dataclass
class FlatMap:
    """Dense padded arrays; the device-facing map image.

    Legacy bucket algorithms carry the aux planes Ceph derives when it
    makes a bucket (reference crush_make_*_bucket): straw scaling factors
    (crush_calc_straw), list cumulative sums, and tree node weights —
    so the rule walk needs no per-walk recomputation."""

    items: np.ndarray  # int32 [B, S]
    weights: np.ndarray  # uint32 [B, S]
    sizes: np.ndarray  # int32 [B]
    algs: np.ndarray  # int32 [B]
    types: np.ndarray  # int32 [B]
    max_devices: int
    tunables: Tunables
    straws: Optional[np.ndarray] = None        # uint32 [B, S] (straw)
    sum_weights: Optional[np.ndarray] = None   # uint32 [B, S] (list)
    tree_weights: Optional[np.ndarray] = None  # uint32 [B, NN] (tree)
    tree_nodes: Optional[np.ndarray] = None    # int32 [B] num_nodes


def calc_straws(weights: Sequence[int], version: int = 0) -> List[int]:
    """Original-straw scaling factors (reference:
    crush_calc_straw; version 0 is crush_create's default, with its
    zero-weight numleft quirk)."""
    import math

    size = len(weights)
    order = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[order[i]] == 0:
            straws[order[i]] = 0
            i += 1
            if version >= 1:
                numleft -= 1
            continue
        straws[order[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        if version == 0 and weights[order[i]] == weights[order[i - 1]]:
            continue
        wbelow += (float(weights[order[i - 1]]) - lastw) * numleft
        if version == 0:
            j = i
            while j < size and weights[order[j]] == weights[order[i]]:
                numleft -= 1
                j += 1
        else:
            numleft -= 1
        wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
        lastw = float(weights[order[i - 1]])
    return straws


def calc_tree_depth(size: int) -> int:
    """calc_depth of Ceph's tree bucket construction."""
    if size == 0:
        return 0
    depth = 1
    t = size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


def calc_tree_weights(weights: Sequence[int]) -> List[int]:
    """Tree bucket node weights: leaf i at node 2i+1, every ancestor
    accumulates (reference: crush_make_tree_bucket,
    crush.h:504 crush_calc_tree_node)."""
    size = len(weights)
    depth = calc_tree_depth(size)
    num_nodes = 1 << depth
    nw = [0] * num_nodes

    def height(n: int) -> int:
        h = 0
        while (n & 1) == 0:
            h += 1
            n >>= 1
        return h

    def parent(n: int) -> int:
        h = height(n)
        if n & (1 << (h + 1)):
            return n - (1 << h)
        return n + (1 << h)

    for i, w in enumerate(weights):
        node = ((i + 1) << 1) - 1
        nw[node] = w
        for _ in range(1, depth):
            node = parent(node)
            nw[node] += w
    return nw


class CrushMap:
    def __init__(self, tunables: Optional[Tunables] = None):
        self.buckets: Dict[int, Bucket] = {}
        self.rules: List[Rule] = []
        self.tunables = tunables or Tunables()
        self.type_names: Dict[int, str] = {0: "osd"}
        # bucket id -> name (reference CrushWrapper name_map); filled by
        # the text compiler, optional everywhere else
        self.bucket_names: Dict[int, str] = {}
        # named weight-set overrides (reference CrushWrapper choose_args):
        # name -> {bucket_id: [16.16 weights]}
        self.choose_args: Dict[str, Dict[int, List[int]]] = {}
        self._next_id = -1

    # -- construction -----------------------------------------------------
    def add_bucket(
        self,
        alg: int,
        type: int,
        items: Sequence[int] = (),
        weights: Sequence[int] = (),
        id: Optional[int] = None,
    ) -> int:
        if id is None:
            id = self._next_id
        if id >= 0 or id in self.buckets:
            raise ValueError(f"bad bucket id {id}")
        self._next_id = min(self._next_id, id) - 1
        self.buckets[id] = Bucket(id, alg, type, list(items), list(weights))
        return id

    def add_item(self, bucket_id: int, item: int, weight: int) -> None:
        b = self.buckets[bucket_id]
        b.items.append(item)
        b.weights.append(weight)

    def reweight_item(self, bucket_id: int, item: int, weight: int) -> None:
        b = self.buckets[bucket_id]
        i = b.items.index(item)
        b.weights[i] = weight

    def remove_item(self, bucket_id: int, item: int) -> None:
        b = self.buckets[bucket_id]
        i = b.items.index(item)
        del b.items[i]
        del b.weights[i]

    def add_rule(self, rule: Rule) -> int:
        self.rules.append(rule)
        return len(self.rules) - 1

    def add_simple_rule(
        self,
        name: str,
        root_id: int,
        failure_domain_type: int,
        mode: str = "firstn",
        num: int = 0,
    ) -> int:
        """Equivalent of CrushWrapper::add_simple_rule
        (reference: src/crush/CrushWrapper.h:1155): take root, then
        choose/chooseleaf over the failure domain, then emit."""
        steps: List[Tuple[int, int, int]] = [(OP_TAKE, root_id, 0)]
        op = (
            OP_CHOOSELEAF_FIRSTN if mode == "firstn" else OP_CHOOSELEAF_INDEP
        )
        if failure_domain_type == 0:
            op = OP_CHOOSE_FIRSTN if mode == "firstn" else OP_CHOOSE_INDEP
        steps.append((op, num, failure_domain_type))
        steps.append((OP_EMIT, 0, 0))
        return self.add_rule(
            Rule(name, steps, type=1 if mode == "firstn" else 3)
        )

    @property
    def max_devices(self) -> int:
        mx = 0
        for b in self.buckets.values():
            for it in b.items:
                if it >= 0:
                    mx = max(mx, it + 1)
        return mx

    # -- device image ------------------------------------------------------
    def flatten(self) -> FlatMap:
        if not self.buckets:
            raise ValueError("empty crush map")
        n_buckets = max(-b for b in self.buckets) if self.buckets else 0
        max_size = max((len(b.items) for b in self.buckets.values()), default=1)
        max_size = max(max_size, 1)
        items = np.zeros((n_buckets, max_size), dtype=np.int32)
        weights = np.zeros((n_buckets, max_size), dtype=np.uint32)
        sizes = np.zeros(n_buckets, dtype=np.int32)
        algs = np.zeros(n_buckets, dtype=np.int32)
        types = np.zeros(n_buckets, dtype=np.int32)
        legacy_algs = {b.alg for b in self.buckets.values()} - {ALG_STRAW2}
        straws = sum_w = tree_w = tree_n = None
        if ALG_STRAW in legacy_algs:
            straws = np.zeros((n_buckets, max_size), dtype=np.uint32)
        if ALG_LIST in legacy_algs:
            sum_w = np.zeros((n_buckets, max_size), dtype=np.uint32)
        if ALG_TREE in legacy_algs:
            max_nodes = max(
                (1 << calc_tree_depth(len(b.items))
                 for b in self.buckets.values() if b.alg == ALG_TREE),
                default=1)
            tree_w = np.zeros((n_buckets, max_nodes), dtype=np.uint32)
            tree_n = np.zeros(n_buckets, dtype=np.int32)
        for bid, b in self.buckets.items():
            bno = -1 - bid
            n = len(b.items)
            items[bno, :n] = b.items
            weights[bno, :n] = b.weights
            sizes[bno] = n
            algs[bno] = b.alg
            types[bno] = b.type
            if b.alg == ALG_STRAW and straws is not None and n:
                straws[bno, :n] = calc_straws(
                    b.weights, version=self.tunables.straw_calc_version)
            if b.alg == ALG_LIST and sum_w is not None and n:
                sum_w[bno, :n] = np.cumsum(
                    np.asarray(b.weights, dtype=np.uint64)
                ).astype(np.uint32)
            if b.alg == ALG_TREE and tree_w is not None and n:
                nw = calc_tree_weights(b.weights)
                tree_w[bno, : len(nw)] = nw
                tree_n[bno] = len(nw)
        return FlatMap(
            items=items,
            weights=weights,
            sizes=sizes,
            algs=algs,
            types=types,
            max_devices=self.max_devices,
            tunables=self.tunables,
            straws=straws,
            sum_weights=sum_w,
            tree_weights=tree_w,
            tree_nodes=tree_n,
        )


def build_flat_cluster(
    n_osds: int,
    osd_weight: int = 0x10000,
    *,
    hosts: int = 0,
    host_type: int = 1,
) -> Tuple[CrushMap, int]:
    """Convenience constructor: root straw2 bucket over osds (or over
    ``hosts`` straw2 host buckets of n_osds/hosts osds each).  Returns
    (map, root_id).  The shape crushtool --build produces for benches
    (reference: src/tools/crushtool.cc:112-218)."""
    m = CrushMap()
    if hosts:
        per = n_osds // hosts
        host_ids = []
        for h in range(hosts):
            osds = list(range(h * per, (h + 1) * per))
            hid = m.add_bucket(
                ALG_STRAW2, host_type, osds, [osd_weight] * per
            )
            host_ids.append(hid)
        root = m.add_bucket(
            ALG_STRAW2,
            10,
            host_ids,
            [osd_weight * per] * hosts,
        )
    else:
        root = m.add_bucket(
            ALG_STRAW2, 10, list(range(n_osds)), [osd_weight] * n_osds
        )
    return m, root


def flatmap_from_arrays(
    items,
    weights,
    sizes,
    algs,
    types,
    max_devices: int,
    tunables,
    straws=None,
    sum_weights=None,
    tree_weights=None,
    tree_nodes=None,
) -> FlatMap:
    """The port's FlatMap from the arrays of another one (the fields of
    ``ceph_tpu.crush.map.FlatMap``, as numpy arrays): the same map, held
    by this package.  ``tunables`` is a dict of :class:`Tunables`
    fields or a Tunables-like object; the optional legacy aux planes
    stay None where absent."""
    if not isinstance(tunables, dict):
        tunables = {f.name: getattr(tunables, f.name)
                    for f in dataclasses.fields(Tunables)}

    def arr(a, dtype):
        return None if a is None else np.array(a, dtype=dtype)

    items = arr(items, np.int32)
    if items.ndim != 2:
        raise ValueError(f"items must be [B, S], got {items.shape}")
    flat = FlatMap(
        items=items,
        weights=arr(weights, np.uint32),
        sizes=arr(sizes, np.int32),
        algs=arr(algs, np.int32),
        types=arr(types, np.int32),
        max_devices=int(max_devices),
        tunables=Tunables(**{k: int(v) for k, v in tunables.items()}),
        straws=arr(straws, np.uint32),
        sum_weights=arr(sum_weights, np.uint32),
        tree_weights=arr(tree_weights, np.uint32),
        tree_nodes=arr(tree_nodes, np.int32),
    )
    b, s = items.shape
    for name in ("weights", "straws", "sum_weights"):
        a = getattr(flat, name)
        if a is not None and a.shape != (b, s):
            raise ValueError(f"{name} must be [{b}, {s}], got {a.shape}")
    for name in ("sizes", "algs", "types", "tree_nodes"):
        a = getattr(flat, name)
        if a is not None and a.shape != (b,):
            raise ValueError(f"{name} must be [{b}], got {a.shape}")
    return flat
