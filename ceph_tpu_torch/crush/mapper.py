"""CRUSH placement over a flattened map: the rule walk and the staged sweeps.

Port of ``ceph_tpu/crush/mapper.py``: :func:`compile_rule` (``:1103``),
:func:`sweep` (``:1321``) and :func:`sweep_device` (``:1395``) with their
signatures, results and caching, plus ``device=``.  The reference
compiles a rule into a vmapped jit program whose shape is a workaround
for the TPU: the descent unrolled at trace time, every lane paying the
batch's worst-case retries, the straw2 quotient from u32 limbs, and
hash-order ("fastcmp") draws that flag ambiguous lanes.  Here the walk
is ``ops/crush_rule.py``: on the card the CUDA kernel ``csrc/crush.cu``,
one thread per object id running Ceph's scalar ``crush_do_rule`` with
exact 64-bit draws; on the CPU its plain PyTorch version.

The staged sweeps keep their structure and capacities: a one-attempt
pass (budget 1), a pass at :data:`MID_BUDGET` over the unclean ids, and
the exact walk over what is left.  Each stage is one launch of the same
kernel at a different budget.  The port's ``clean`` has no draw
ambiguity among its reasons (its draws are exact), so its unclean sets
are subsets of the reference's, and its results are the same.

Every entry point takes ``device=``: ``None`` means CUDA and raises
without a card; ``"cpu"`` runs the plain version.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.crush.map import FlatMap
from ceph_tpu_torch.ops import crush_rule

# mid-stage retry budget for the staged sweeps: real retry semantics
# for this many attempts per choose; the rest go to the exact walk
MID_BUDGET = 3

_cache: dict = {}  # content digest -> RuleMap / runner (process lifetime)
_cache_lock = threading.RLock()
_CACHE_MAX = 256


def _rule_digest(flat: FlatMap, steps, result_max: int,
                 choose_args) -> str:
    """Content key of a (map, rule, choose_args): two maps with
    identical arrays share one device map and one runner."""
    h = hashlib.sha1()
    for arr in (flat.items, flat.weights, flat.sizes, flat.algs,
                flat.types, flat.straws, flat.sum_weights,
                flat.tree_weights, flat.tree_nodes):
        if arr is not None:
            a = np.ascontiguousarray(arr)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    h.update(repr(flat.tunables).encode())
    h.update(repr((flat.max_devices, result_max, list(steps))).encode())
    if choose_args:
        for bid in sorted(choose_args):
            h.update(repr((bid, list(choose_args[bid]))).encode())
    return h.hexdigest()


def _cached(key, make):
    with _cache_lock:
        got = _cache.get(key)
        if got is None:
            got = make()
            _cache[key] = got
            if len(_cache) > _CACHE_MAX:
                _cache.pop(next(iter(_cache)))
        return got


def _map_digest(flat: FlatMap, choose_args) -> str:
    return _rule_digest(flat, (), 0, choose_args)


def device_map(flat: FlatMap, choose_args=None,
               device=None) -> crush_rule.RuleMap:
    """The map's device tensors, built once per map content and device."""
    dev = resolve_device(device)
    return _cached(("map", _map_digest(flat, choose_args), str(dev)),
                   lambda: crush_rule.RuleMap(flat, choose_args, dev))


def _as_ids(xs, dev: torch.device) -> torch.Tensor:
    if isinstance(xs, torch.Tensor):
        return xs.to(device=dev, dtype=torch.int32).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(xs).astype(np.int32))).to(dev)


def _as_weights(dev_weights, dev: torch.device) -> torch.Tensor:
    """16.16 reweights as the int32 words of their u32 values."""
    if isinstance(dev_weights, torch.Tensor):
        w = dev_weights.to(dev)
        if w.dtype != torch.int32:
            w = (w.to(torch.int64) & 0xFFFFFFFF)
            w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
        return w.contiguous()
    w = np.ascontiguousarray(np.asarray(dev_weights).astype(np.uint32))
    return torch.from_numpy(w.view(np.int32)).to(dev)


class _Rule:
    """A compiled rule: fn(xs, dev_weights) -> int32 [N, result_max] on
    the device (and bool clean [N] with a budget)."""

    def __init__(self, rm: crush_rule.RuleMap, spec: crush_rule.RuleSpec,
                 budget: int) -> None:
        self.rm, self.spec, self.budget = rm, spec, budget

    def __call__(self, xs, dev_weights):
        dev = self.rm.device
        x = _as_ids(xs, dev).reshape(-1)
        w = _as_weights(dev_weights, dev)
        out = torch.empty((x.numel(), self.spec.result_max),
                          dtype=torch.int32, device=dev)
        clean = (torch.empty(x.numel(), dtype=torch.uint8, device=dev)
                 if self.budget else None)
        crush_rule.launch(self.rm, self.spec, w, x, out, budget=self.budget,
                          clean=clean)
        if self.budget:
            return out, clean.bool()
        return out


def compile_rule(
    flat: FlatMap,
    steps: Sequence[Tuple[int, int, int]],
    result_max: int,
    choose_args=None,
    one_shot: bool = False,
    budget: Optional[int] = None,
    device=None,
):
    """Build fn(xs[int32 N], device_weights[uint32 D]) -> int32 [N,
    result_max] on the device, holes ``ITEM_NONE``.

    ``choose_args`` ({bucket_id: [weights]}) substitutes straw2 weight
    sets (reference crush_do_rule's choose_args).  ``one_shot=True``
    gives every choose one attempt (budget 1) and ``budget=N`` N
    attempts; both return (result, clean[bool N]), and a clean id's row
    is the full walk's.  On the card every call is one launch of the
    kernel; at N=1 it is the scalar walk.  Compiled rules and their
    device maps are cached by map content."""
    budget_val = (1 if one_shot else 0) if budget is None else int(budget)
    dev = resolve_device(device)
    key = ("rule", _rule_digest(flat, steps, result_max, choose_args),
           budget_val, str(dev))

    def make():
        return _Rule(device_map(flat, choose_args, dev),
                     crush_rule.RuleSpec(steps, result_max), budget_val)

    return _cached(key, make)


def _stages(rm, spec, w, xs, out, chunk: int, cap: int, cap2: int,
            stage_events=None):
    """The three staged launches over xs (a multiple of chunk long) into
    out, chained on the device: per chunk a budget-1 pass appending its
    unclean ids to a chunk/cap buffer and a MID_BUDGET pass over them
    appending to the sweep's stage-3 buffer; then the exact walk over
    that.  Returns the device counts (per-chunk stage-1, stage-3)."""
    dev = xs.device
    n = xs.numel()
    n_chunks = n // chunk
    bad1 = torch.empty(cap, dtype=torch.int32, device=dev)
    counts1 = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    bad3 = torch.empty(cap2, dtype=torch.int32, device=dev)
    count3 = torch.zeros(1, dtype=torch.int32, device=dev)

    def timed(stage, fn):
        if stage_events is None:
            fn()
            return
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        stage_events.setdefault(stage, []).append((t0, t1))

    for c in range(n_chunks):
        lo = c * chunk
        sub, sub_out = xs[lo:lo + chunk], out[lo:lo + chunk]
        cnt = counts1[c:c + 1]
        timed(1, lambda: crush_rule.launch(
            rm, spec, w, sub, sub_out, budget=1, bad=bad1, bad_count=cnt))
        timed(2, lambda: crush_rule.launch(
            rm, spec, w, sub, sub_out, budget=MID_BUDGET, lanes=bad1,
            lane_count=cnt, bad=bad3, bad_count=count3, idx_base=lo))
    timed(3, lambda: crush_rule.launch(
        rm, spec, w, xs, out, budget=0, lanes=bad3, lane_count=count3))
    return counts1, count3


def sweep(
    flat: FlatMap,
    steps: Sequence[Tuple[int, int, int]],
    result_max: int,
    xs: np.ndarray,
    dev_weights: np.ndarray,
    choose_args=None,
    chunk: int = 1 << 19,
    device=None,
) -> np.ndarray:
    """Full-cluster placement sweep (the ParallelPGMapper workload,
    reference src/osd/OSDMapMapping.h:17) as three stages, returned on
    the host: a one-attempt pass over each chunk, a :data:`MID_BUDGET`
    pass over its unclean ids, and the exact walk over the residue, each
    stage sized to the whole chunk so that nothing can overflow.
    Bit-exact with the full walk on every id (a clean id's row is the
    full walk's)."""
    dev = resolve_device(device)
    x = _as_ids(xs, dev).reshape(-1)
    n = x.numel()
    if n == 0:
        return np.empty((0, result_max), dtype=np.int32)
    chunk = max(1, min(chunk, n))
    pad = -n % chunk
    if pad:  # uniform chunks: the last id repeated
        x = torch.cat([x, x[-1:].expand(pad)])
    rm = device_map(flat, choose_args, dev)
    spec = crush_rule.RuleSpec(steps, result_max)
    w = _as_weights(dev_weights, dev)
    out = torch.empty((x.numel(), result_max), dtype=torch.int32, device=dev)
    for lo in range(0, x.numel(), chunk):
        _stages(rm, spec, w, x[lo:lo + chunk], out[lo:lo + chunk], chunk,
                chunk, chunk)
    return out[:n].cpu().numpy()


def sweep_device(
    flat: FlatMap,
    steps: Sequence[Tuple[int, int, int]],
    result_max: int,
    xs,
    dev_weights,
    choose_args=None,
    chunk: int = 1 << 19,
    bad_div: int = 8,
    bad2_div: int = 2048,
    device=None,
    stage_events: Optional[dict] = None,
):
    """Device-resident staged sweep: placements and the overflow flag
    stay on the device, and nothing waits on the host.

    The same three stages as :func:`sweep` at fixed capacities:

    1. a one-attempt pass over each chunk, whose unclean ids the kernel
       appends to a buffer of chunk/bad_div entries;
    2. a :data:`MID_BUDGET` pass over them, appending the ids still
       unclean to one sweep-wide buffer of max(n/bad2_div, 2048);
    3. the exact walk over that buffer, once, after every chunk.

    If a stage's unclean count passes its capacity, the returned flag is
    True and the caller must fall back to :func:`sweep` (ids past the
    capacity keep an earlier stage's row, which may differ from the full
    walk's).  bad_div=1, bad2_div=1 gives full capacity at every stage.
    ``stage_events`` (a dict, CUDA only) collects a (start, end) CUDA
    event pair per launch under its stage number.

    xs length must be a multiple of `chunk`.  Returns (placements i32
    [N, result_max] ON DEVICE, overflow bool ON DEVICE)."""
    dev = resolve_device(device)
    x = _as_ids(xs, dev).reshape(-1)
    n = x.numel()
    chunk = min(chunk, n)
    if chunk <= 0 or n % chunk:
        raise ValueError(f"{n} ids are not a whole number of {chunk}-id "
                         "chunks")
    cap = max(1, chunk // bad_div)
    cap2 = min(n, max(n // bad2_div, 2048))
    rm = device_map(flat, choose_args, dev)
    spec = crush_rule.RuleSpec(steps, result_max)
    out = torch.empty((n, result_max), dtype=torch.int32, device=dev)
    counts1, count3 = _stages(rm, spec, _as_weights(dev_weights, dev), x,
                              out, chunk, cap, cap2, stage_events)
    overflow = (counts1 > cap).any() | (count3[0] > cap2)
    return out, overflow

