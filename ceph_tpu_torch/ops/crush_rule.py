"""The CRUSH rule walk (K6): CUDA kernel wrapper and plain PyTorch version.

Port of the device program ``ceph_tpu/crush/mapper.py:1103``
(``compile_rule``: the vmapped ``one_x`` at ``:1157``).  The function:
for each object id x, Ceph's ``crush_do_rule`` over a flattened map --
the rule's steps in order (take, the choose / chooseleaf firstn and
indep steps, emit, and the ``OP_SET_*`` steps that override the
tunables for the steps after them), every bucket algorithm (straw2,
uniform, list, tree, straw), retries with collide / reject, reweight
rejection, the chooseleaf recursion with vary_r and stable -- giving
int32 ``[N, result_max]`` padded with ``ITEM_NONE``; indep keeps its
positional holes, firstn is compacted.  ``csrc/crush_oracle.cc`` (which
the JAX package's tests pin as ``_native.do_rule``) is the scalar model.

An attempt budget serves the staged sweeps: ``budget`` 0 runs the
rule's own tries; ``budget`` B > 0 refuses any retry once B attempts
were made at a choose (a firstn rep, an indep round loop, or either
inside the leaf recursion), and a refusal clears the id's ``clean``
flag.  A clean id met no refusal, so it took exactly the attempts of the
full walk and its row is the full walk's.

Two implementations of the same function:

- :func:`launch` on a CUDA tensor runs ``csrc/crush.cu`` (count
  ``crush_rule``): one thread per id runs the scalar walk.  Its straw2
  scan keeps a running leader and takes the exact draw only where the
  hash order does not settle a comparison (``ln.fastcmp_bounds``), the
  quotient as a multiply by a reciprocal; :func:`straw2_scan_plain` and
  :func:`recip_div_plain` are those two pieces as PyTorch ops, for the
  tests.  It can walk
  a list of ids read from the device (a previous stage's append buffer
  and its count) and append its own unclean ids to another, so that a
  staged sweep chains on the device without a host sync;
- :func:`rule_plain` is the same walk written as PyTorch ops vectorised
  over ids, with masks and index sets for the retry state.  It runs on
  any device: it is the CPU path and the kernel's reference on the card.
  For a few ids on the CPU (a ``pg_to_up_acting``) :func:`launch` takes
  :func:`rule_scalar` instead, the kernel's walk on Python integers.

Hashes are computed in int64 masked to 32 bits (``crush.hashes``), the
straw2 draw with int64 ln values and a truncating divide
(``crush.ln``).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.crush import hashes, ln
from ceph_tpu_torch.crush.ln_table import LL_TBL, RH_LH_TBL
from ceph_tpu_torch.crush.map import (
    ALG_LIST,
    ALG_STRAW,
    ALG_STRAW2,
    ALG_TREE,
    ALG_UNIFORM,
    ITEM_NONE,
    ITEM_UNDEF,
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
    FlatMap,
)
from ceph_tpu_torch.gpu.devwatch import instrumented_launch, signature
from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("crush_rule")

MAX_RESULT = 32  # csrc kMaxResult: entries of a work vector
MAX_STEPS = 32   # csrc kMaxSteps: steps of a rule
# the launch's counters: straw2 draws, other hashes, bucket choices, and
# the straw2 draws settled on the exact path
N_STATS = 4
_M32 = 0xFFFFFFFF
_CHOOSES = (OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP, OP_CHOOSELEAF_FIRSTN,
            OP_CHOOSELEAF_INDEP)


def _u32_words(a) -> torch.Tensor:
    """u32 values as an int32 tensor of the same bits (the kernel's
    view), on the CPU."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32))


def _u32_values(t: torch.Tensor) -> torch.Tensor:
    """int32 words holding u32 bits -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & _M32


def recip_magic(weights) -> np.ndarray:
    """floor((2^64 - 1) / w) for each u32 weight (1 for w == 0, whose
    draw never divides), as the int64 bits of the u64 values: the
    reciprocal operand of the kernel's straw2 quotient."""
    w = np.maximum(np.asarray(weights, dtype=np.uint64), np.uint64(1))
    return (np.uint64(0xFFFFFFFFFFFFFFFF) // w).view(np.int64)


class RuleMap:
    """A flattened map on one device, as the rule walk reads it.

    ``weights`` are the straw2 draw weights: the map's, with
    ``choose_args`` ({bucket_id: [16.16 weights]}) substituted in straw2
    buckets only, as the reference's ``bucket_straw2_choose`` consults
    its weight set (``ceph_tpu/crush/mapper.py:111-126``).  ``magic``
    holds each weight's :func:`recip_magic` (a choose_args map has its
    own).  The kernel takes the int32 planes (u32 fields as their bits);
    the plain version takes int64 copies made on first use."""

    def __init__(self, flat: FlatMap, choose_args=None,
                 device: torch.device = torch.device("cpu")) -> None:
        items = np.asarray(flat.items, dtype=np.int32)
        if items.ndim != 2 or not items.size:
            raise ValueError(f"map items must be [B, S], got {items.shape}")
        weights = np.array(flat.weights, dtype=np.uint32)
        algs = np.asarray(flat.algs, dtype=np.int32)
        sizes = np.asarray(flat.sizes, dtype=np.int32)
        for bid, ws in (choose_args or {}).items():
            bno = -1 - int(bid)
            if 0 <= bno < weights.shape[0] and algs[bno] == ALG_STRAW2:
                weights[bno, :len(ws)] = np.asarray(ws, dtype=np.uint32)
        present = {int(a) for a, s in zip(algs, sizes) if s > 0}
        for alg, plane in ((ALG_STRAW, flat.straws),
                           (ALG_LIST, flat.sum_weights),
                           (ALG_TREE, flat.tree_weights),
                           (ALG_TREE, flat.tree_nodes)):
            if alg in present and plane is None:
                raise ValueError(f"bucket alg {alg} needs its aux plane")
        self.device = device
        self.n_buckets, self.max_size = items.shape
        self.max_devices = int(flat.max_devices)
        t = flat.tunables
        self.tunables = (int(t.choose_total_tries), int(t.choose_local_tries),
                         int(t.choose_local_fallback_tries),
                         int(t.chooseleaf_descend_once),
                         int(t.chooseleaf_vary_r), int(t.chooseleaf_stable))

        def dev(x):
            return None if x is None else x.to(device)

        self.items = dev(torch.from_numpy(items.copy()))
        self.weights = dev(_u32_words(weights))
        self.magic = dev(torch.from_numpy(recip_magic(weights)))
        self.sizes = dev(torch.from_numpy(sizes.copy()))
        self.algs = dev(torch.from_numpy(algs.copy()))
        self.types = dev(torch.from_numpy(
            np.asarray(flat.types, dtype=np.int32).copy()))
        self.straws = dev(None if flat.straws is None
                          else _u32_words(flat.straws))
        self.sum_weights = dev(None if flat.sum_weights is None
                               else _u32_words(flat.sum_weights))
        self.tree_weights = dev(None if flat.tree_weights is None
                                else _u32_words(flat.tree_weights))
        self.tree_nodes = dev(None if flat.tree_nodes is None
                              else torch.from_numpy(np.asarray(
                                  flat.tree_nodes, dtype=np.int32).copy()))
        self.tree_stride = (0 if flat.tree_weights is None
                            else int(np.asarray(flat.tree_weights).shape[1]))
        self._tables = None
        self._plain = None
        self._scalar = None
        self._lock = threading.Lock()

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The crush_ln tables on the device, as the kernel reads them."""
        with self._lock:
            if self._tables is None:
                self._tables = tuple(
                    torch.from_numpy(np.asarray(t, dtype=np.uint64)
                                     .view(np.int64)).to(self.device)
                    for t in (RH_LH_TBL, LL_TBL))
            return self._tables

    def plain(self) -> dict:
        """int64 planes for the plain version (u32 fields as values)."""
        with self._lock:
            if self._plain is None:
                p = {k: getattr(self, k).to(torch.int64)
                     for k in ("items", "sizes", "algs", "types")}
                p["weights"] = _u32_values(self.weights)
                for k in ("straws", "sum_weights", "tree_weights"):
                    v = getattr(self, k)
                    p[k] = None if v is None else _u32_values(v)
                p["tree_nodes"] = (None if self.tree_nodes is None
                                   else self.tree_nodes.to(torch.int64))
                self._plain = p
            return self._plain

    def scalar(self) -> dict:
        """The plain planes as Python lists, for :func:`rule_scalar`."""
        p = self.plain()
        with self._lock:
            if self._scalar is None:
                self._scalar = {k: None if v is None else v.tolist()
                                for k, v in p.items()}
            return self._scalar


class RuleSpec:
    """A rule's steps and result width, checked against the kernel's
    limits: ``steps`` (op, arg1, arg2) triples, at most MAX_STEPS, and
    1 <= result_max <= MAX_RESULT."""

    def __init__(self, steps: Sequence[Tuple[int, int, int]],
                 result_max: int) -> None:
        self.steps = [tuple(int(v) for v in s) for s in steps]
        self.result_max = int(result_max)
        if not 1 <= self.result_max <= MAX_RESULT:
            raise ValueError(f"result_max must be in [1, {MAX_RESULT}], got "
                             f"{self.result_max}")
        if len(self.steps) > MAX_STEPS or any(len(s) != 3
                                              for s in self.steps):
            raise ValueError(f"a rule takes at most {MAX_STEPS} (op, arg1, "
                             "arg2) steps")
        self.array = np.zeros(3 * MAX_STEPS, dtype=np.int32)
        if self.steps:
            self.array[:3 * len(self.steps)] = np.asarray(
                self.steps, dtype=np.int32).ravel()


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _nz(mask: torch.Tensor) -> torch.Tensor:
    return mask.nonzero().squeeze(1)


def _limbs(v: torch.Tensor) -> list:
    """The four 16-bit limbs of the 64-bit words ``v`` (int64 bits)."""
    return [(v >> (16 * i)) & 0xFFFF for i in range(4)]


def recip_div_plain(mag: torch.Tensor, wt: torch.Tensor,
                    magic: torch.Tensor) -> torch.Tensor:
    """mag // wt as the kernel computes it: q = mulhi(mag, magic), then
    q += 1 if mag - q * wt >= wt.  ``magic`` is :func:`recip_magic` of
    ``wt`` (int64 bits).  Exact for 0 <= mag <= 2^48 and wt in [1,
    2^32): magic * wt lies in (2^64 - 1 - wt, 2^64 - 1], so mag * magic /
    2^64 lies in (mag / wt - 2^-16, mag / wt) and the estimate is q or
    q - 1.  The 128-bit product is summed in 16-bit limbs, every partial
    inside int64."""
    mag, wt = mag.to(torch.int64), wt.to(torch.int64)
    a, b = _limbs(mag), _limbs(magic.to(torch.int64))
    carry = torch.zeros_like(a[0])
    hi = torch.zeros_like(a[0])
    for col in range(8):
        t = carry
        for i in range(max(0, col - 3), min(col, 3) + 1):
            t = t + a[i] * b[col - i]
        if col >= 4:
            hi = hi | ((t & 0xFFFF) << (16 * (col - 4)))
        carry = t >> 16
    return hi + (mag - hi * wt >= wt).to(torch.int64)


def straw2_scan_plain(u: torch.Tensor, w: torch.Tensor,
                      fast_max: Optional[int] = None):
    """The kernel's straw2 leader scan over rows of 16-bit hashes ``u``
    and u32 weights ``w`` ([L, S], every column an item): (the winning
    column [L], the comparisons settled on the exact path [L]).

    Each item meets the leader once: a zero weight loses, a zero-weight
    leader loses to any positive weight, equal weights with equal hashes
    keep the leader, equal weights w <= ``fast_max`` (default
    ``ln.fastcmp_bounds()[2]``) at hash distance >= 2 go by the hashes,
    and anything else compares the exact draws (:func:`recip_div_plain`
    over the ln table).  Its result is the straw2 choose of mapper.c:
    the first index of the strictly greatest draw."""
    if fast_max is None:
        fast_max = ln.fastcmp_bounds()[2]
    u, w = u.to(torch.int64), w.to(torch.int64)
    magic = torch.from_numpy(recip_magic(w.cpu().numpy())).to(w.device)
    mag = -ln.ln16_tensor(u.device)[u]

    def draw(j, col):
        return -recip_div_plain(mag[j, col], w[j, col], magic[j, col])

    L = u.shape[0]
    rows = torch.arange(L, device=u.device)
    high = torch.zeros(L, dtype=torch.int64, device=u.device)
    exact = torch.zeros_like(high)
    for i in range(1, u.shape[1]):
        ui, wi = u[:, i], w[:, i]
        hu, hw = u[rows, high], w[rows, high]
        live = (wi != 0) & (hw != 0)
        same = live & (wi == hw)
        tie = same & (ui == hu)
        by_hash = same & ~tie & (wi <= fast_max) & ((ui - hu).abs() >= 2)
        slow = _nz(live & ~tie & ~by_hash)
        take = ((wi != 0) & (hw == 0)) | (by_hash & (ui > hu))
        if slow.numel():
            take[slow] = draw(slow, i) > draw(slow, high[slow])
        exact[slow] += 1
        high = torch.where(take, i, high)
    return high, exact


class _PlainWalk:
    """crush_do_rule vectorised over ids.  Every per-id state is a
    tensor over the ids still in play; ``g`` carries their indices into
    the batch, for the clean flags."""

    def __init__(self, rm: RuleMap, dev_weights: torch.Tensor,
                 budget: int, n: int) -> None:
        p = rm.plain()
        self.items, self.weights = p["items"], p["weights"]
        self.sizes, self.algs, self.types = p["sizes"], p["algs"], p["types"]
        self.straws, self.sum_weights = p["straws"], p["sum_weights"]
        self.tree_weights, self.tree_nodes = p["tree_weights"], \
            p["tree_nodes"]
        self.nb, self.max_devices = rm.n_buckets, rm.max_devices
        self.dw = dev_weights
        self.budget = budget
        self.device = self.items.device
        self.clean = torch.ones(n, dtype=torch.bool, device=self.device)

    # -- bucket choices (bno [L] with sizes > 0) ---------------------------
    def _straw2(self, bno, x, r):
        size = self.sizes[bno]
        S = int(size.max())
        items = self.items[bno, :S]
        u = hashes.hash32_3(x[:, None], items, r[:, None], xp=torch) & 0xFFFF
        draw = ln.straw2_draw(u, self.weights[bno, :S], xp=torch)
        valid = torch.arange(S, device=self.device)[None, :] < size[:, None]
        draw = torch.where(valid, draw, torch.full_like(draw, ln.S64_MIN))
        return items.gather(1, draw.argmax(1, keepdim=True)).squeeze(1)

    def _straw(self, bno, x, r):
        size = self.sizes[bno]
        S = int(size.max())
        items = self.items[bno, :S]
        u = hashes.hash32_3(x[:, None], items, r[:, None], xp=torch) & 0xFFFF
        draw = u * self.straws[bno, :S]
        valid = torch.arange(S, device=self.device)[None, :] < size[:, None]
        draw = torch.where(valid, draw, torch.full_like(draw, -1))
        return items.gather(1, draw.argmax(1, keepdim=True)).squeeze(1)

    def _list(self, bno, x, r):
        size = self.sizes[bno]
        S = int(size.max())
        items = self.items[bno, :S]
        h = hashes.hash32_4(x[:, None], items, r[:, None], (-1 - bno)[:, None],
                            xp=torch) & 0xFFFF
        t = (h * self.sum_weights[bno, :S]) >> 16
        valid = torch.arange(S, device=self.device)[None, :] < size[:, None]
        hit = valid & (t < self.weights[bno, :S])
        # the C walks from the tail: the largest index that hits, else 0
        last = (S - 1) - hit.flip(1).to(torch.int8).argmax(1)
        idx = torch.where(hit.any(1), last, torch.zeros_like(last))
        return items.gather(1, idx[:, None]).squeeze(1)

    def _tree(self, bno, x, r):
        nw = self.tree_weights[bno]
        n = self.tree_nodes[bno] >> 1
        bid = -1 - bno
        for _ in range(max(1, nw.shape[1].bit_length())):
            live = (n > 0) & ((n & 1) == 0)
            if not bool(live.any()):
                break
            w = nw.gather(1, n[:, None]).squeeze(1)
            h = hashes.hash32_4(x, n, r, bid, xp=torch)
            # (h * w) >> 32 with both factors below 2^32, inside int64
            t = (h * (w >> 16) + ((h * (w & 0xFFFF)) >> 16)) >> 16
            half = (n & -n) >> 1
            left = n - half
            lw = nw.gather(1, left.clamp(min=0)[:, None]).squeeze(1)
            n = torch.where(live, torch.where(t < lw, left, n + half), n)
        return self.items[bno, n >> 1]

    def _perm(self, bno, x, r):
        """perm[pr] of bucket_perm_choose's permutation, traced back from
        step pr (each step p swaps p and p + hash3(x, id, p) % (size - p))."""
        size = self.sizes[bno]
        bid = -1 - bno
        pr = (r & _M32) % size
        t = pr + hashes.hash32_3(x, bid, pr, xp=torch) % (size - pr)
        for p in range(int(pr.max()) - 1, -1, -1):
            live = p < pr
            i = hashes.hash32_3(x, bid, torch.full_like(pr, p), xp=torch) \
                % (size - p).clamp(min=1)
            t = torch.where(live & (t == p + i), torch.full_like(t, p), t)
        return self.items[bno, t]

    def choose(self, bno, x, r, perm=None):
        """bucket_choose for every id: item [L]."""
        out = self.items[bno, 0].clone()
        alg = self.algs[bno]
        use_perm = alg == ALG_UNIFORM
        if perm is not None:
            use_perm = use_perm | perm
        for sel, fn in ((use_perm, self._perm),
                        (~use_perm & (alg == ALG_STRAW2), self._straw2),
                        (~use_perm & (alg == ALG_LIST), self._list),
                        (~use_perm & (alg == ALG_TREE), self._tree),
                        (~use_perm & (alg == ALG_STRAW), self._straw)):
            idx = _nz(sel)
            if idx.numel():
                out[idx] = fn(bno[idx], x[idx], r[idx])
        return out

    def is_out(self, item, x):
        wmax = self.dw.shape[0]
        w = self.dw[item.clamp(0, wmax - 1)]
        h = hashes.hash32_2(x, item, xp=torch) & 0xFFFF
        out = torch.where(w >= 0x10000, torch.zeros_like(h, dtype=torch.bool),
                          (w == 0) | (h >= w))
        return out | (item >= wmax)

    def item_type(self, item):
        sub = -1 - item
        valid = (item < 0) & (sub < self.nb)
        t = torch.where(valid, self.types[sub.clamp(0, self.nb - 1)],
                        torch.zeros_like(item))
        return t, valid

    def refuse(self, g):
        if g.numel():
            self.clean[g] = False

    # -- crush_choose_firstn ---------------------------------------------
    def firstn_rep(self, g, bucket, x, rep_r, type_, tries, recurse_tries,
                   local_retries, local_fallback, recurse, vary_r, stable,
                   out, outpos, out2):
        """One rep of crush_choose_firstn for each id: (placed [L], item
        [L]).  ``out`` [L, W] holds the items chosen so far (the first
        ``outpos`` are checked for collisions); with ``recurse`` the leaf
        of a placed rep is written to ``out2[:, outpos]``."""
        L = g.numel()
        dev = self.device
        cols = torch.arange(out.shape[1], device=dev)[None, :]
        in_bno = bucket.clone()
        ftotal = torch.zeros(L, dtype=torch.int64, device=dev)
        flocal = torch.zeros_like(ftotal)
        pending = torch.ones(L, dtype=torch.bool, device=dev)
        placed = torch.zeros_like(pending)
        item = torch.zeros_like(ftotal)
        while True:
            idx = _nz(pending)
            if not idx.numel():
                break
            b, xi = in_bno[idx], x[idx]
            r = rep_r[idx] + ftotal[idx]
            fl = flocal[idx]
            size = self.sizes[b]
            empty = size == 0
            it = torch.zeros_like(b)
            ne = _nz(~empty)
            if ne.numel():
                perm = None
                if local_fallback > 0:
                    perm = (fl[ne] >= (size[ne] >> 1)) & (fl[ne] > local_fallback)
                it[ne] = self.choose(b[ne], xi[ne], r[ne], perm)
            bad = ~empty & (it >= self.max_devices)
            itype, valid_sub = self.item_type(it)
            mismatch = ~empty & ~bad & (itype != type_)
            descend = mismatch & valid_sub
            target = ~empty & ~bad & ~mismatch
            op = outpos[idx]
            collide = target & ((out[idx] == it[:, None])
                                & (cols < op[:, None])).any(1)
            reject = torch.zeros_like(collide)
            if recurse:
                dv = _nz(target & ~collide & (it >= 0))
                if dv.numel():
                    out2[idx[dv], op[dv]] = it[dv]
                lf = _nz(target & ~collide & (it < 0))
                if lf.numel():
                    rows = idx[lf]
                    rr = r[lf]
                    sub_r = (rr >> (vary_r - 1)) if vary_r else \
                        torch.zeros_like(rr)
                    leaf_rep = torch.zeros_like(rr) if stable else op[lf]
                    ok, leaf = self.firstn_rep(
                        g[rows], -1 - it[lf], xi[lf], leaf_rep + sub_r, 0,
                        recurse_tries, 0, local_retries, local_fallback,
                        False, vary_r, stable, out2[rows], op[lf], None)
                    put = _nz(ok)
                    out2[rows[put], op[lf][put]] = leaf[put]
                    reject[lf] = ~ok
            dev0 = _nz(target & ~reject & ~collide & (itype == 0))
            if dev0.numel():
                reject[dev0] = self.is_out(it[dev0], xi[dev0])
            success = target & ~reject & ~collide
            failed = empty | (target & (reject | collide))
            item[idx[success]] = it[success]
            placed[idx[success]] = True
            pending[idx[success | bad | (mismatch & ~valid_sub)]] = False
            in_bno[idx[descend]] = -1 - it[descend]
            fi = idx[failed]
            if fi.numel():
                ftotal[fi] += 1
                flocal[fi] += 1
                ft, flc, sz = ftotal[fi], flocal[fi], size[failed]
                rb = collide[failed] & (flc <= local_retries)
                if local_fallback > 0:
                    rb = rb | (flc <= sz + local_fallback)
                rd = ~rb & (ft < tries)
                skip = ~rb & ~rd
                if self.budget > 0:
                    refused = (rb | rd) & (ft >= self.budget)
                    self.refuse(g[fi[refused]])
                    rb, rd = rb & ~refused, rd & ~refused
                    skip = skip | refused
                back = fi[rd]
                in_bno[back] = bucket[back]
                flocal[back] = 0
                pending[fi[skip]] = False
        return placed, item

    def firstn(self, g, bucket, x, numrep, type_, count, tries,
               recurse_tries, local_retries, local_fallback, recurse,
               vary_r, stable, width):
        """crush_choose_firstn from each id's bucket: (values [L, width],
        count [L]); values are the leaves with ``recurse``."""
        L = g.numel()
        out = torch.full((L, width), ITEM_NONE, dtype=torch.int64,
                         device=self.device)
        out2 = out.clone()
        outpos = torch.zeros(L, dtype=torch.int64, device=self.device)
        for rep in range(numrep):
            ai = _nz(count > outpos)
            if not ai.numel():
                break
            sub2 = out2[ai]
            placed, item = self.firstn_rep(
                g[ai], bucket[ai], x[ai], torch.full_like(ai, rep), type_,
                tries, recurse_tries, local_retries, local_fallback, recurse,
                vary_r, stable, out[ai], outpos[ai], sub2)
            out2[ai] = sub2
            pi = ai[placed]
            out[pi, outpos[pi]] = item[placed]
            outpos[pi] += 1
        return (out2 if recurse else out), outpos

    # -- crush_choose_indep ----------------------------------------------
    def indep(self, g, bucket, x, left_n, numrep, type_, tries,
              recurse_tries, recurse, out, out2, outpos, parent_r):
        """crush_choose_indep over slots [outpos, outpos + left_n) of
        ``out`` (and ``out2`` with ``recurse``), in place."""
        dev = self.device
        nslot = int(left_n.max()) if left_n.numel() else 0
        if nslot == 0:
            return
        slots = torch.arange(outpos, outpos + nslot, device=dev)[None, :]
        in_range = slots < (outpos + left_n)[:, None]
        cols = slice(outpos, outpos + nslot)
        out[:, cols] = torch.where(in_range, ITEM_UNDEF, out[:, cols])
        if out2 is not None:
            out2[:, cols] = torch.where(in_range, ITEM_UNDEF, out2[:, cols])
        left = left_n.clone()
        limit = tries
        if 0 < self.budget < tries:
            limit = self.budget
        for ftotal in range(limit):
            if not bool((left > 0).any()):
                break
            for rep in range(outpos, outpos + nslot):
                cand = _nz((rep < outpos + left_n) & (out[:, rep] == ITEM_UNDEF))
                in_bno = bucket[cand]
                while cand.numel():
                    xi = x[cand]
                    size = self.sizes[in_bno]
                    uniform = (self.algs[in_bno] == ALG_UNIFORM) & \
                        (size % numrep == 0)
                    r = rep + parent_r[cand] + torch.where(
                        uniform, numrep + 1, numrep) * ftotal
                    live = _nz(size > 0)  # an empty bucket: try next round
                    cand, in_bno, xi, r = cand[live], in_bno[live], \
                        xi[live], r[live]
                    if not cand.numel():
                        break
                    it = self.choose(in_bno, xi, r)
                    itype, valid_sub = self.item_type(it)
                    mismatch = itype != type_
                    none = (it >= self.max_devices) | (mismatch & ~valid_sub)
                    descend = ~none & mismatch
                    hit = ~none & ~mismatch
                    ni = cand[none]
                    out[ni, rep] = ITEM_NONE
                    if out2 is not None:
                        out2[ni, rep] = ITEM_NONE
                    left[ni] -= 1
                    # a collision against any slot of this choose ends the
                    # attempt
                    lo, hi = outpos, outpos + nslot
                    span = torch.arange(lo, hi, device=dev)[None, :] < \
                        (outpos + left_n[cand])[:, None]
                    collide = ((out[cand, lo:hi] == it[:, None]) & span).any(1)
                    ok = hit & ~collide
                    if recurse:
                        dv = _nz(ok & (it >= 0))
                        out2[cand[dv], rep] = it[dv]
                        lf = _nz(ok & (it < 0))
                        if lf.numel():
                            rows = cand[lf]
                            sub2 = out2[rows]
                            self.indep(g[rows], -1 - it[lf], xi[lf],
                                       torch.ones_like(rows), numrep, 0,
                                       recurse_tries, 0, False, sub2, None,
                                       rep, r[lf])
                            out2[rows] = sub2
                            ok[lf] = sub2[:, rep] != ITEM_NONE
                    dev0 = _nz(ok & (itype == 0))
                    if dev0.numel():
                        ok[dev0] = ~self.is_out(it[dev0], xi[dev0])
                    pi = cand[ok]
                    out[pi, rep] = it[ok]
                    left[pi] -= 1
                    cand, in_bno = cand[descend], -1 - it[descend]
        if limit < tries:
            self.refuse(g[_nz(left > 0)])
        for buf in (out, out2):
            if buf is not None:
                seg = buf[:, cols]
                buf[:, cols] = torch.where(in_range & (seg == ITEM_UNDEF),
                                           ITEM_NONE, seg)

    # -- crush_do_rule -------------------------------------------------------
    def run(self, rule: RuleSpec, tunables, xs):
        dev = self.device
        N, R = xs.numel(), rule.result_max
        g = torch.arange(N, device=dev)
        x = xs.to(torch.int64) & _M32
        w = torch.full((N, R), ITEM_NONE, dtype=torch.int64, device=dev)
        wsize = torch.zeros(N, dtype=torch.int64, device=dev)
        result = torch.full_like(w, ITEM_NONE)
        rlen = torch.zeros_like(wsize)
        total, local_retries, local_fallback, descend_once, vary_r, stable = \
            tunables
        choose_tries, leaf_tries = total + 1, 0
        for op, a1, a2 in rule.steps:
            if op == OP_TAKE:
                if 0 <= a1 < self.max_devices or 0 <= -1 - a1 < self.nb:
                    w[:, 0] = a1
                    wsize[:] = 1
            elif op == OP_SET_CHOOSE_TRIES:
                choose_tries = a1 if a1 > 0 else choose_tries
            elif op == OP_SET_CHOOSELEAF_TRIES:
                leaf_tries = a1 if a1 > 0 else leaf_tries
            elif op == OP_SET_CHOOSE_LOCAL_TRIES:
                local_retries = a1 if a1 >= 0 else local_retries
            elif op == OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                local_fallback = a1 if a1 >= 0 else local_fallback
            elif op == OP_SET_CHOOSELEAF_VARY_R:
                vary_r = a1 if a1 >= 0 else vary_r
            elif op == OP_SET_CHOOSELEAF_STABLE:
                stable = a1 if a1 >= 0 else stable
            elif op in _CHOOSES:
                firstn = op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN)
                recurse = op in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP)
                numrep = a1 if a1 > 0 else a1 + R
                o = torch.full_like(w, ITEM_NONE)
                osize = torch.zeros_like(wsize)
                for i in range(R if numrep > 0 else 0):
                    bno = -1 - w[:, i]
                    li = _nz((wsize > i) & (bno >= 0) & (bno < self.nb))
                    if not li.numel():
                        continue
                    if firstn:
                        recurse_tries = leaf_tries or (
                            1 if descend_once else choose_tries)
                        vals, cnt = self.firstn(
                            g[li], bno[li], x[li], numrep, a2, R - osize[li],
                            choose_tries, recurse_tries, local_retries,
                            local_fallback, recurse, vary_r, stable, R)
                    else:
                        cnt = (R - osize[li]).clamp(max=numrep)
                        outb = torch.full((li.numel(), R), ITEM_NONE,
                                          dtype=torch.int64, device=dev)
                        out2b = outb.clone()
                        self.indep(g[li], bno[li], x[li], cnt, numrep, a2,
                                   choose_tries, leaf_tries or 1, recurse,
                                   outb, out2b, 0, torch.zeros_like(li))
                        vals = out2b if recurse else outb
                    for j in range(R):
                        m = _nz(cnt > j)
                        if not m.numel():
                            break
                        o[li[m], osize[li[m]] + j] = vals[m, j]
                    osize[li] += cnt
                w, wsize = o, osize
            elif op == OP_EMIT:
                for i in range(R):
                    m = _nz((wsize > i) & (rlen < R))
                    if not m.numel():
                        break
                    result[m, rlen[m]] = w[m, i]
                    rlen[m] += 1
                wsize = torch.zeros_like(wsize)
        return result.to(torch.int32), self.clean


def rule_plain(rm: RuleMap, rule: RuleSpec, dev_weights: torch.Tensor,
               xs: torch.Tensor, budget: int = 0):
    """The rule walk as PyTorch ops on ``xs``'s device: (int32 [N,
    result_max], bool clean [N]).  ``dev_weights`` holds the 16.16
    reweights: u32 values, or their bits in int32."""
    walk = _PlainWalk(rm, _u32_values(dev_weights.to(xs.device)),
                      int(budget), xs.numel())
    return walk.run(rule, rm.tunables, xs.reshape(-1))


# ---------------------------------------------------------------------------
# the plain version's scalar route: a few ids on the CPU
# ---------------------------------------------------------------------------

# At or below this many ids on the CPU, :func:`launch` walks each id on
# Python integers (:func:`rule_scalar`) instead of :func:`rule_plain`'s
# tensor ops, whose per-op cost dominates a walk of one id (a
# ``pg_to_up_acting``).
SCALAR_MAX = 32


def _mix(a, b, c):
    """One crush_hashmix round on Python ints holding u32 values."""
    a = ((a - b - c) & _M32) ^ (c >> 13)
    b = ((b - c - a) & _M32) ^ ((a << 8) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 13)
    a = ((a - b - c) & _M32) ^ (c >> 12)
    b = ((b - c - a) & _M32) ^ ((a << 16) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 5)
    a = ((a - b - c) & _M32) ^ (c >> 3)
    b = ((b - c - a) & _M32) ^ ((a << 10) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 15)
    return a, b, c


def _hash2(a, b):
    a, b = a & _M32, b & _M32
    h = hashes.CRUSH_HASH_SEED ^ a ^ b
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def _hash3(a, b, c):
    """crush_hash32_3, its five mix rounds written out: the scalar
    walk's hot spot (straw2 hashes every item of a bucket)."""
    a, b, c = a & _M32, b & _M32, c & _M32
    h = hashes.CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = 231232, 1232
    a = ((a - b - h) & 0xFFFFFFFF) ^ (h >> 13)
    b = ((b - h - a) & 0xFFFFFFFF) ^ ((a << 8) & 0xFFFFFFFF)
    h = ((h - a - b) & 0xFFFFFFFF) ^ (b >> 13)
    a = ((a - b - h) & 0xFFFFFFFF) ^ (h >> 12)
    b = ((b - h - a) & 0xFFFFFFFF) ^ ((a << 16) & 0xFFFFFFFF)
    h = ((h - a - b) & 0xFFFFFFFF) ^ (b >> 5)
    a = ((a - b - h) & 0xFFFFFFFF) ^ (h >> 3)
    b = ((b - h - a) & 0xFFFFFFFF) ^ ((a << 10) & 0xFFFFFFFF)
    h = ((h - a - b) & 0xFFFFFFFF) ^ (b >> 15)
    c = ((c - x - h) & 0xFFFFFFFF) ^ (h >> 13)
    x = ((x - h - c) & 0xFFFFFFFF) ^ ((c << 8) & 0xFFFFFFFF)
    h = ((h - c - x) & 0xFFFFFFFF) ^ (x >> 13)
    c = ((c - x - h) & 0xFFFFFFFF) ^ (h >> 12)
    x = ((x - h - c) & 0xFFFFFFFF) ^ ((c << 16) & 0xFFFFFFFF)
    h = ((h - c - x) & 0xFFFFFFFF) ^ (x >> 5)
    c = ((c - x - h) & 0xFFFFFFFF) ^ (h >> 3)
    x = ((x - h - c) & 0xFFFFFFFF) ^ ((c << 10) & 0xFFFFFFFF)
    h = ((h - c - x) & 0xFFFFFFFF) ^ (x >> 15)
    y = ((y - a - h) & 0xFFFFFFFF) ^ (h >> 13)
    a = ((a - h - y) & 0xFFFFFFFF) ^ ((y << 8) & 0xFFFFFFFF)
    h = ((h - y - a) & 0xFFFFFFFF) ^ (a >> 13)
    y = ((y - a - h) & 0xFFFFFFFF) ^ (h >> 12)
    a = ((a - h - y) & 0xFFFFFFFF) ^ ((y << 16) & 0xFFFFFFFF)
    h = ((h - y - a) & 0xFFFFFFFF) ^ (a >> 5)
    y = ((y - a - h) & 0xFFFFFFFF) ^ (h >> 3)
    a = ((a - h - y) & 0xFFFFFFFF) ^ ((y << 10) & 0xFFFFFFFF)
    h = ((h - y - a) & 0xFFFFFFFF) ^ (a >> 15)
    b = ((b - x - h) & 0xFFFFFFFF) ^ (h >> 13)
    x = ((x - h - b) & 0xFFFFFFFF) ^ ((b << 8) & 0xFFFFFFFF)
    h = ((h - b - x) & 0xFFFFFFFF) ^ (x >> 13)
    b = ((b - x - h) & 0xFFFFFFFF) ^ (h >> 12)
    x = ((x - h - b) & 0xFFFFFFFF) ^ ((b << 16) & 0xFFFFFFFF)
    h = ((h - b - x) & 0xFFFFFFFF) ^ (x >> 5)
    b = ((b - x - h) & 0xFFFFFFFF) ^ (h >> 3)
    x = ((x - h - b) & 0xFFFFFFFF) ^ ((b << 10) & 0xFFFFFFFF)
    h = ((h - b - x) & 0xFFFFFFFF) ^ (x >> 15)
    y = ((y - c - h) & 0xFFFFFFFF) ^ (h >> 13)
    c = ((c - h - y) & 0xFFFFFFFF) ^ ((y << 8) & 0xFFFFFFFF)
    h = ((h - y - c) & 0xFFFFFFFF) ^ (c >> 13)
    y = ((y - c - h) & 0xFFFFFFFF) ^ (h >> 12)
    c = ((c - h - y) & 0xFFFFFFFF) ^ ((y << 16) & 0xFFFFFFFF)
    h = ((h - y - c) & 0xFFFFFFFF) ^ (c >> 5)
    y = ((y - c - h) & 0xFFFFFFFF) ^ (h >> 3)
    c = ((c - h - y) & 0xFFFFFFFF) ^ ((y << 10) & 0xFFFFFFFF)
    h = ((h - y - c) & 0xFFFFFFFF) ^ (c >> 15)
    return h


def _hash4(a, b, c, d):
    a, b, c, d = a & _M32, b & _M32, c & _M32, d & _M32
    h = hashes.CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


@functools.lru_cache(maxsize=None)
def _ln16() -> list:
    """:func:`ln.ln16_table` as a list of Python ints."""
    return ln.ln16_table().tolist()


class _ScalarWalk:
    """crush_do_rule for one id at a time on Python integers: the
    kernel's walk (``csrc/crush.cu`` ``do_rule``) line for line, with the
    same budget and clean flag."""

    def __init__(self, rm: RuleMap, dev_weights: list, budget: int) -> None:
        p = rm.scalar()
        self.items, self.weights = p["items"], p["weights"]
        self.sizes, self.algs, self.types = p["sizes"], p["algs"], p["types"]
        self.straws, self.sum_weights = p["straws"], p["sum_weights"]
        self.tree_weights, self.tree_nodes = p["tree_weights"], \
            p["tree_nodes"]
        self.nb, self.max_devices = rm.n_buckets, rm.max_devices
        self.dw = dev_weights
        self.budget = budget
        self.ln16 = _ln16()
        self.x = 0
        self.clean = True

    # -- bucket choices ----------------------------------------------------
    def _straw2(self, bno, size, r):
        """The first index of the strictly greatest exact draw."""
        items, wts, x = self.items[bno], self.weights[bno], self.x
        high, hdraw = 0, ln.S64_MIN
        for i in range(size):
            wt = wts[i]
            if wt == 0:
                draw = ln.S64_MIN
            else:
                draw = -(-self.ln16[_hash3(x, items[i], r) & 0xFFFF] // wt)
            if i == 0 or draw > hdraw:
                high, hdraw = i, draw
        return items[high]

    def _perm(self, bno, size, r):
        bid = -1 - bno
        pr = (r & _M32) % size
        t = pr
        if pr < size - 1:
            t = pr + _hash3(self.x, bid, pr) % (size - pr)
        for p in range(pr - 1, -1, -1):
            if t == p + _hash3(self.x, bid, p) % (size - p):
                t = p
        return self.items[bno][t]

    def _straw(self, bno, size, r):
        items, straws = self.items[bno], self.straws[bno]
        high, high_draw = 0, 0
        for i in range(size):
            draw = (_hash3(self.x, items[i], r) & 0xFFFF) * straws[i]
            if i == 0 or draw > high_draw:
                high, high_draw = i, draw
        return items[high]

    def _list(self, bno, size, r):
        items, sw, wts = self.items[bno], self.sum_weights[bno], \
            self.weights[bno]
        bid = -1 - bno
        for i in range(size - 1, -1, -1):
            t = ((_hash4(self.x, items[i], r, bid) & 0xFFFF) * sw[i]) >> 16
            if t < wts[i]:
                return items[i]
        return items[0]

    def _tree(self, bno, r):
        nw = self.tree_weights[bno]
        bid = -1 - bno
        n = self.tree_nodes[bno] >> 1
        while n > 0 and not n & 1:
            t = (_hash4(self.x, n, r, bid) * nw[n]) >> 32
            half = (n & -n) >> 1
            n = n - half if t < nw[n - half] else n + half
        return self.items[bno][n >> 1]

    def choose(self, bno, r, perm=False):
        size = self.sizes[bno]
        alg = self.algs[bno]
        if perm or alg == ALG_UNIFORM:
            return self._perm(bno, size, r)
        if alg == ALG_STRAW2:
            return self._straw2(bno, size, r)
        if alg == ALG_LIST:
            return self._list(bno, size, r)
        if alg == ALG_TREE:
            return self._tree(bno, r)
        if alg == ALG_STRAW:
            return self._straw(bno, size, r)
        return self.items[bno][0]

    def is_out(self, item):
        if item >= len(self.dw):
            return True
        wt = self.dw[max(item, 0)]
        if wt >= 0x10000:
            return False
        if wt == 0:
            return True
        return (_hash2(self.x, item) & 0xFFFF) >= wt

    def item_type(self, item):
        if item < 0 and -1 - item < self.nb:
            return self.types[-1 - item], True
        return 0, False

    # -- crush_choose_firstn ---------------------------------------------
    def firstn(self, bucket, numrep, type_, out, outpos, out_size, tries,
               recurse_tries, local_retries, local_fallback, recurse,
               vary_r, stable, out2, parent_r, outer):
        count = out_size
        rep = 0 if stable else outpos
        while rep < numrep and count > 0:
            ftotal = 0
            skip = False
            item = 0
            retry_descent = True
            while retry_descent:
                retry_descent = False
                in_bno, flocal = bucket, 0
                retry_bucket = True
                while retry_bucket:
                    retry_bucket = False
                    r = rep + parent_r + ftotal
                    size = self.sizes[in_bno]
                    collide = reject = False
                    if size == 0:
                        reject = True
                    else:
                        perm = (local_fallback > 0 and flocal >= size >> 1
                                and flocal > local_fallback)
                        item = self.choose(in_bno, r, perm)
                        if item >= self.max_devices:
                            skip = True
                            break
                        itype, valid = self.item_type(item)
                        if itype != type_:
                            if not valid:
                                skip = True
                                break
                            in_bno = -1 - item
                            retry_bucket = True
                            continue
                        collide = item in out[:outpos]
                        if outer and not collide and recurse:
                            if item < 0:
                                sub_r = (r >> (vary_r - 1)) if vary_r else 0
                                if self.firstn(
                                        -1 - item, 1 if stable else outpos + 1,
                                        0, out2, outpos, count, recurse_tries,
                                        0, local_retries, local_fallback,
                                        False, vary_r, stable, None, sub_r,
                                        False) <= outpos:
                                    reject = True
                            else:
                                out2[outpos] = item
                        if not reject and not collide and itype == 0:
                            reject = self.is_out(item)
                    if reject or collide:
                        ftotal += 1
                        flocal += 1
                        if collide and flocal <= local_retries:
                            retry_bucket = True
                        elif local_fallback > 0 and \
                                flocal <= size + local_fallback:
                            retry_bucket = True
                        elif ftotal < tries:
                            retry_descent = True
                        else:
                            skip = True
                        if (retry_bucket or retry_descent) and \
                                self.budget > 0 and ftotal >= self.budget:
                            self.clean = False
                            retry_bucket = retry_descent = False
                            skip = True
            rep += 1
            if skip:
                continue
            out[outpos] = item
            outpos += 1
            count -= 1
        return outpos

    # -- crush_choose_indep ----------------------------------------------
    def indep(self, bucket, left, numrep, type_, out, outpos, tries,
              recurse_tries, recurse, out2, parent_r, outer):
        endpos = outpos + left
        for rep in range(outpos, endpos):
            out[rep] = ITEM_UNDEF
            if outer:
                out2[rep] = ITEM_UNDEF
        limit = self.budget if 0 < self.budget < tries else tries
        ftotal = 0
        while left > 0 and ftotal < limit:
            for rep in range(outpos, endpos):
                if out[rep] != ITEM_UNDEF:
                    continue
                in_bno = bucket
                while True:
                    size = self.sizes[in_bno]
                    step = numrep + 1 if (self.algs[in_bno] == ALG_UNIFORM
                                          and size % numrep == 0) else numrep
                    r = rep + parent_r + step * ftotal
                    if size == 0:
                        break
                    item = self.choose(in_bno, r)
                    itype, valid = self.item_type(item)
                    if item >= self.max_devices or \
                            (itype != type_ and not valid):
                        out[rep] = ITEM_NONE
                        if outer:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    if itype != type_:
                        in_bno = -1 - item
                        continue
                    if item in out[outpos:endpos]:
                        break
                    if outer and recurse:
                        if item < 0:
                            self.indep(-1 - item, 1, numrep, 0, out2, rep,
                                       recurse_tries, 0, False, None, r,
                                       False)
                            if out2[rep] == ITEM_NONE:
                                break
                        else:
                            out2[rep] = item
                    if itype == 0 and self.is_out(item):
                        break
                    out[rep] = item
                    left -= 1
                    break
            ftotal += 1
        if left > 0 and limit < tries:
            self.clean = False  # the budget ran out
        for rep in range(outpos, endpos):
            if out[rep] == ITEM_UNDEF:
                out[rep] = ITEM_NONE
            if outer and out2[rep] == ITEM_UNDEF:
                out2[rep] = ITEM_NONE

    # -- crush_do_rule -------------------------------------------------------
    def run(self, rule: RuleSpec, tunables, x: int):
        self.x, self.clean = x & _M32, True
        R = rule.result_max
        wv: list = []
        result: list = []
        total, local_retries, local_fallback, descend_once, vary_r, stable = \
            tunables
        choose_tries, leaf_tries = total + 1, 0
        for op, a1, a2 in rule.steps:
            if op == OP_TAKE:
                if 0 <= a1 < self.max_devices or 0 <= -1 - a1 < self.nb:
                    wv = [a1]
            elif op == OP_SET_CHOOSE_TRIES:
                choose_tries = a1 if a1 > 0 else choose_tries
            elif op == OP_SET_CHOOSELEAF_TRIES:
                leaf_tries = a1 if a1 > 0 else leaf_tries
            elif op == OP_SET_CHOOSE_LOCAL_TRIES:
                local_retries = a1 if a1 >= 0 else local_retries
            elif op == OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                local_fallback = a1 if a1 >= 0 else local_fallback
            elif op == OP_SET_CHOOSELEAF_VARY_R:
                vary_r = a1 if a1 >= 0 else vary_r
            elif op == OP_SET_CHOOSELEAF_STABLE:
                stable = a1 if a1 >= 0 else stable
            elif op in _CHOOSES and wv:
                firstn = op in (OP_CHOOSE_FIRSTN, OP_CHOOSELEAF_FIRSTN)
                recurse = op in (OP_CHOOSELEAF_FIRSTN, OP_CHOOSELEAF_INDEP)
                numrep = a1 if a1 > 0 else a1 + R
                ov: list = []
                cv: list = []
                for item in wv:
                    bno = -1 - item
                    if numrep <= 0 or not 0 <= bno < self.nb:
                        continue
                    ob, cb = [ITEM_NONE] * R, [ITEM_NONE] * R
                    if firstn:
                        recurse_tries = leaf_tries or (
                            1 if descend_once else choose_tries)
                        n = self.firstn(bno, numrep, a2, ob, 0, R - len(ov),
                                        choose_tries, recurse_tries,
                                        local_retries, local_fallback,
                                        recurse, vary_r, stable, cb, 0, True)
                    else:
                        n = min(numrep, R - len(ov))
                        self.indep(bno, n, numrep, a2, ob, 0, choose_tries,
                                   leaf_tries or 1, recurse, cb, 0, True)
                    ov += ob[:n]
                    cv += cb[:n]
                wv = cv if recurse else ov
            elif op == OP_EMIT:
                result += wv[:R - len(result)]
                wv = []
        return result + [ITEM_NONE] * (R - len(result)), self.clean


def rule_scalar(rm: RuleMap, rule: RuleSpec, dev_weights: torch.Tensor,
                xs: torch.Tensor, budget: int = 0):
    """:func:`rule_plain`'s function, each id walked on Python integers:
    (int32 [N, result_max], bool clean [N]) on the CPU.  It is the CPU
    route for a few ids (:data:`SCALAR_MAX`)."""
    walk = _ScalarWalk(rm, _u32_values(dev_weights.cpu()).tolist(),
                       int(budget))
    rows, clean = [], []
    for x in xs.reshape(-1).tolist():
        row, ok = walk.run(rule, rm.tunables, x)
        rows.append(row)
        clean.append(ok)
    return (torch.tensor(rows, dtype=torch.int32).reshape(
        len(rows), rule.result_max), torch.tensor(clean, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the kernel's launch
# ---------------------------------------------------------------------------


class _RuleArgs(ctypes.Structure):
    """Mirror of ``RuleArgs`` in csrc/crush.cu, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "items", "weights", "magic", "sizes", "algs", "types", "straws",
        "sum_weights", "tree_weights", "tree_nodes", "dev_weights", "rh_lh",
        "ll", "xs", "out", "clean", "lanes", "lane_count", "bad",
        "bad_count", "stats")] + [("n", ctypes.c_int64)] + [
        (name, ctypes.c_int32) for name in (
            "n_buckets", "max_size", "max_devices", "weight_max",
            "tree_stride", "result_max", "budget", "bad_cap", "idx_base")] + [
        ("fast_max", ctypes.c_uint32), ("tunables", ctypes.c_int32 * 6), ("n_steps", ctypes.c_int32),
        ("steps", ctypes.c_int32 * (3 * MAX_STEPS))]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: Optional[torch.Tensor], dtype, what: str, device) -> None:
    if t is None:
        return
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor on "
                         f"{device}")


def launch(rm: RuleMap, rule: RuleSpec, dev_weights: torch.Tensor,
           xs: torch.Tensor, out: torch.Tensor, *, budget: int = 0,
           clean: Optional[torch.Tensor] = None,
           lanes: Optional[torch.Tensor] = None,
           lane_count: Optional[torch.Tensor] = None,
           bad: Optional[torch.Tensor] = None,
           bad_count: Optional[torch.Tensor] = None, idx_base: int = 0,
           stats: Optional[torch.Tensor] = None) -> None:
    """Walk the rule for ids of ``xs`` (int32 [N]) into rows of ``out``
    (int32 [N, result_max]), on ``xs``'s device.

    - ``lanes`` (int32 [cap]) with ``lane_count`` (int32 [1]): walk only
      the ids ``lanes[:min(lane_count, cap)]``; else every id;
    - ``clean`` (uint8 [N]): each walked id's clean flag;
    - ``bad`` (int32 [cap]) with ``bad_count`` (int32 [1]): append the
      index (plus ``idx_base``) of each unclean walked id; the count
      goes on past the capacity, so ``bad_count > cap`` tells an
      overflow;
    - ``stats`` (int64 [N_STATS], CUDA only): add the walk's straw2
      draws, other hashes, bucket choices and straw2 draws settled on
      the exact path.

    On a CUDA tensor one kernel launch does it, on the current stream,
    without a host sync; on a CPU tensor :func:`rule_plain` does."""
    dev = xs.device
    _check(xs, torch.int32, "xs", dev)
    _check(out, torch.int32, "out", dev)
    _check(clean, torch.uint8, "clean", dev)
    for t, what in ((lanes, "lanes"), (lane_count, "lane_count"),
                    (bad, "bad"), (bad_count, "bad_count")):
        _check(t, torch.int32, what, dev)
    if out.dim() != 2 or out.shape != (xs.numel(), rule.result_max):
        raise ValueError(f"out must be [{xs.numel()}, {rule.result_max}]")
    if (lanes is None) != (lane_count is None) or \
            (bad is None) != (bad_count is None):
        raise ValueError("lanes and bad each come with their count")
    if budget < 0:
        raise ValueError("budget must be >= 0")
    if dev.type == "cuda":
        if rm.device != dev:
            raise ValueError(f"the map lies on {rm.device}, the ids on "
                             f"{dev}")
        _check(dev_weights, torch.int32, "dev_weights", dev)
        _check(stats, torch.int64, "stats", dev)
        if dev_weights.numel() < 1:
            raise ValueError("dev_weights must hold at least one weight")
        if stats is not None and stats.numel() != N_STATS:
            raise ValueError(f"stats must hold {N_STATS} counters")
    elif dev.type != "cpu":
        raise ValueError(f"crush_rule runs on cuda or cpu, not {dev}")
    instrumented_launch(
        "crush_rule", signature((xs, dev_weights), {}),
        lambda: _walk(rm, rule, dev_weights, xs, out, budget, clean, lanes,
                      lane_count, bad, bad_count, idx_base, stats), dev)


def _walk(rm, rule, dev_weights, xs, out, budget, clean, lanes, lane_count,
          bad, bad_count, idx_base, stats) -> None:
    """:func:`launch` after its checks: the plain walk on the CPU, one
    kernel launch on the card."""
    dev = xs.device
    if dev.type == "cpu":
        _launch_plain(rm, rule, dev_weights, xs, out, budget, clean, lanes,
                      lane_count, bad, bad_count, idx_base)
        return
    rh_lh, ll = rm.tables()
    a = _RuleArgs()
    a.items, a.weights, a.magic = _ptr(rm.items), _ptr(rm.weights), \
        _ptr(rm.magic)
    a.sizes, a.fast_max = _ptr(rm.sizes), ln.fastcmp_bounds()[2]
    a.algs, a.types, a.straws = _ptr(rm.algs), _ptr(rm.types), \
        _ptr(rm.straws)
    a.sum_weights, a.tree_weights = _ptr(rm.sum_weights), \
        _ptr(rm.tree_weights)
    a.tree_nodes, a.dev_weights = _ptr(rm.tree_nodes), _ptr(dev_weights)
    a.rh_lh, a.ll, a.xs, a.out = _ptr(rh_lh), _ptr(ll), _ptr(xs), _ptr(out)
    a.clean, a.lanes, a.lane_count = _ptr(clean), _ptr(lanes), \
        _ptr(lane_count)
    a.bad, a.bad_count, a.stats = _ptr(bad), _ptr(bad_count), _ptr(stats)
    a.n = lanes.numel() if lanes is not None else xs.numel()
    a.n_buckets, a.max_size = rm.n_buckets, rm.max_size
    a.max_devices, a.weight_max = rm.max_devices, dev_weights.numel()
    a.tree_stride, a.result_max = rm.tree_stride, rule.result_max
    a.budget, a.bad_cap = int(budget), 0 if bad is None else bad.numel()
    a.idx_base = int(idx_base)
    a.tunables[:] = rm.tunables
    a.n_steps = len(rule.steps)
    a.steps[:] = rule.array.tolist()
    lib = _build.lib()
    if lib.crush_rule_args_size() != ctypes.sizeof(_RuleArgs):
        raise RuntimeError("csrc/crush.cu RuleArgs and its ctypes mirror "
                           "differ in size")
    err = lib.crush_rule_launch(ctypes.byref(a),
                                torch.cuda.current_stream(dev).cuda_stream)
    launches.inc()
    _build.check(err, "crush_rule")


def _launch_plain(rm, rule, dev_weights, xs, out, budget, clean, lanes,
                  lane_count, bad, bad_count, idx_base) -> None:
    """:func:`launch`'s contract on the CPU, through :func:`rule_plain`
    (:func:`rule_scalar` for at most :data:`SCALAR_MAX` ids): unclean
    ids are appended in index order."""
    if lanes is not None:
        n = max(0, min(int(lane_count[0]), lanes.numel()))
        sel = lanes[:n].to(torch.int64)
    else:
        sel = torch.arange(xs.numel())
    walk = rule_scalar if sel.numel() <= SCALAR_MAX else rule_plain
    res, ok = walk(rm, rule, dev_weights, xs[sel], budget)
    out[sel] = res
    if clean is not None:
        clean[sel] = ok.to(torch.uint8)
    if bad is not None:
        unclean = sel[~ok].to(torch.int32) + int(idx_base)
        start = int(bad_count[0])
        room = max(0, min(unclean.numel(), bad.numel() - start))
        bad[start:start + room] = unclean[:room]
        bad_count[0] = start + unclean.numel()
