"""OSDMap — versioned cluster map and the object->PG->OSD pipeline.

Port of ``ceph_tpu/osd/osdmap.py`` (reference: src/osd/OSDMap.cc,
src/osd/osd_types.cc):

- object name -> placement seed: rjenkins string hash, optional
  namespace with 0x1F separator (pg_pool_t::hash_key,
  osd_types.cc:1468)
- ps -> pg via ceph_stable_mod (include/rados.h:85), pg -> pps mixing
  the pool id under HASHPSPOOL (raw_pg_to_pps, osd_types.cc:1500-1516)
- pps -> raw osds via CRUSH (_pg_to_raw_osds -> crush do_rule,
  OSDMap.cc:2198-2210)
- upmap exception table (_apply_upmap, :2228), up filtering
  (_raw_to_up_osds, :2275), primary affinity (:2300), pg_temp /
  primary_temp overrides (_get_temp_osds, :2356),
  pg_to_up_acting_osds (:2417)

Both placement paths run the rule walk of ``crush.mapper.compile_rule``
(the CUDA kernel ``csrc/crush.cu`` on the card, its plain PyTorch
version with ``device="cpu"``):

- ``pg_to_up_acting``, the per-op path, walks one seed: one launch;
- ``map_pgs`` (the OSDMapMapping / ParallelPGMapper role, reference
  src/osd/OSDMapMapping.h:17) walks every PG of a pool in one launch,
  brings the rows to the host once, and applies the exception tables,
  the up filter and primary affinity there with numpy, vectorised.

The map's state (OSD states, weights, affinities, pools, exception
tables, addresses) lives on the host, because the codec and the
incrementals read and write it, and several writers change it in place.
So nothing is cached on the device by epoch: every walk uploads
``osd_weight`` and the seeds, and the device copy of the CRUSH map is
shared by content (``crush.mapper``'s cache).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.crush import hashes
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.crush import mapper as cmapper
from ceph_tpu_torch.device import resolve_device

CRUSH_ITEM_NONE = 0x7FFFFFFF
DEFAULT_PRIMARY_AFFINITY = 0x10000
MAX_PRIMARY_AFFINITY = 0x10000

POOL_REPLICATED = 1
POOL_ERASURE = 3

FLAG_HASHPSPOOL = 1

_FIRSTN = (cmap.OP_CHOOSE_FIRSTN, cmap.OP_CHOOSELEAF_FIRSTN)
_INDEP = (cmap.OP_CHOOSE_INDEP, cmap.OP_CHOOSELEAF_INDEP)


def stable_mod(x: int, b: int, bmask: int) -> int:
    """ceph_stable_mod (reference: src/include/rados.h:85)."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def pg_num_mask(b: int) -> int:
    """Smallest (2^n)-1 containing b (b=12 -> 15)."""
    m = 1
    while m < b:
        m <<= 1
    return m - 1


def seeds_as_ids(pps) -> np.ndarray:
    """u32 placement seeds as the int32 words of their bits: the ids the
    rule walk takes (a seed past 2^31 becomes a negative word, never a
    wrapped or clipped value)."""
    return np.ascontiguousarray(np.asarray(pps, dtype=np.uint32)).view(
        np.int32)


def rule_result_len(steps, result_max: int) -> Optional[int]:
    """The length of crush_do_rule's result for a rule whose choose steps
    are all indep: each such step yields min(numrep, room) entries per
    input, holes included, so the length does not depend on the seed.
    None when a firstn step makes it depend on the walk (a firstn row
    is compacted: its length is the count of leading non-NONE entries).
    The walk's rows are padded to result_max with ITEM_NONE, so this is
    what tells an indep hole from the padding."""
    if any(op in _FIRSTN for op, _, _ in steps):
        return None
    wsize = rlen = 0
    buckets = False  # whether the working vector holds buckets
    for op, arg1, arg2 in steps:
        if op == cmap.OP_TAKE:
            wsize, buckets = 1, arg1 < 0
        elif op in _INDEP and wsize:
            numrep = arg1 if arg1 > 0 else arg1 + result_max
            osize = 0
            if numrep > 0 and buckets:  # the walk skips a device input
                for _ in range(wsize):
                    osize += min(numrep, result_max - osize)
            wsize = osize
            buckets = op == cmap.OP_CHOOSE_INDEP and arg2 != 0
        elif op == cmap.OP_EMIT:
            rlen = min(result_max, rlen + wsize)
            wsize = 0
    return rlen


@dataclasses.dataclass
class PGPool:
    pool_id: int
    pool_type: int = POOL_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 64
    pgp_num: int = 64
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    object_hash: str = "rjenkins"
    erasure_code_profile: str = ""
    name: str = ""
    # hit-set tracking (cache-tier statistics; reference pg_pool_t
    # hit_set_params/period/count, src/osd/osd_types.h): count == 0
    # disables tracking
    hit_set_count: int = 0
    hit_set_period: float = 0.0
    hit_set_target_size: int = 1000
    hit_set_fpp: float = 0.01

    @property
    def pg_num_mask_(self) -> int:
        return pg_num_mask(self.pg_num)

    @property
    def pgp_num_mask_(self) -> int:
        return pg_num_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        return self.pool_type == POOL_REPLICATED

    def hash_key(self, key: str | bytes, nspace: str | bytes = b"") -> int:
        if isinstance(key, str):
            key = key.encode()
        if isinstance(nspace, str):
            nspace = nspace.encode()
        buf = key if not nspace else nspace + b"\x1f" + key
        return hashes.str_hash_rjenkins(buf)

    def raw_pg_to_pg_ps(self, ps: int) -> int:
        return stable_mod(ps, self.pg_num, self.pg_num_mask_)

    def raw_pg_to_pps(self, ps: int) -> int:
        m = stable_mod(ps, self.pgp_num, self.pgp_num_mask_)
        if self.flags & FLAG_HASHPSPOOL:
            return int(hashes.hash32_2(np.uint32(m), np.uint32(self.pool_id)))
        return m + self.pool_id

    def pps_vector(self, pgs: np.ndarray) -> np.ndarray:
        """Vectorized raw_pg_to_pps over pg seed numbers [N] (already
        stable_mod'ed into [0, pg_num)): uint32 [N]."""
        ps = np.asarray(pgs, dtype=np.int64)
        m = np.where(
            (ps & self.pgp_num_mask_) < self.pgp_num,
            ps & self.pgp_num_mask_,
            ps & (self.pgp_num_mask_ >> 1),
        ).astype(np.uint32)
        if self.flags & FLAG_HASHPSPOOL:
            return np.asarray(
                hashes.hash32_2(m, np.uint32(self.pool_id))).astype(np.uint32)
        return (m + np.uint32(self.pool_id)).astype(np.uint32)


class OSDMap:
    """Cluster map: crush + osd states + pools + exception tables.

    ``device`` is where the rule walk runs: None means CUDA (and raises
    without a card), ``"cpu"`` the plain walk."""

    def __init__(self, crush: cmap.CrushMap, max_osd: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.epoch = 1
        self.crush = crush
        self.max_osd = max_osd or crush.max_devices
        self.osd_state_up = np.ones(self.max_osd, dtype=bool)
        self.osd_state_exists = np.ones(self.max_osd, dtype=bool)
        self.osd_weight = np.full(self.max_osd, 0x10000, dtype=np.uint32)
        self.osd_primary_affinity: Optional[np.ndarray] = None
        self.pools: Dict[int, PGPool] = {}
        self.pg_upmap: Dict[Tuple[int, int], List[int]] = {}
        self.pg_upmap_items: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        self.pg_temp: Dict[Tuple[int, int], List[int]] = {}
        self.primary_temp: Dict[Tuple[int, int], int] = {}
        # entity addresses published with the map (reference: osd_addrs
        # + hb_front/back_addrs in OSDMap); heartbeats get their own
        # endpoint so a busy data path can never stall liveness probes
        self.osd_addrs: Dict[int, Tuple[str, int]] = {}
        self.osd_hb_addrs: Dict[int, Tuple[str, int]] = {}
        self._flat = None
        self._rule_fns: Dict[Tuple[int, int], object] = {}

    # -- epoch / state mutation -------------------------------------------
    def bump_epoch(self) -> None:
        self.epoch += 1
        self._flat = None
        self._rule_fns.clear()

    def set_osd_down(self, osd: int) -> None:
        self.osd_state_up[osd] = False
        self.bump_epoch()

    def set_osd_up(self, osd: int) -> None:
        self.osd_state_up[osd] = True
        self.osd_state_exists[osd] = True
        self.bump_epoch()

    def set_osd_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0
        self.bump_epoch()

    def set_osd_in(self, osd: int) -> None:
        self.osd_weight[osd] = 0x10000
        self.bump_epoch()

    def reweight_osd(self, osd: int, weight_16_16: int) -> None:
        self.osd_weight[osd] = weight_16_16
        self.bump_epoch()

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = np.full(
                self.max_osd, DEFAULT_PRIMARY_AFFINITY, dtype=np.uint32)
        self.osd_primary_affinity[osd] = aff
        self.bump_epoch()

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state_exists[osd])

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state_up[osd])

    def add_pool(self, pool: PGPool) -> None:
        self.pools[pool.pool_id] = pool
        self.bump_epoch()

    # -- the rule walk ----------------------------------------------------
    def _flatten(self) -> cmap.FlatMap:
        if self._flat is None:
            flat = self.crush.flatten()
            # the COMPAT weight-set (reference choose_args id -1, written
            # by the balancer's crush-compat mode and read by
            # bucket_straw2_choose): substitute straw2 draw weights in the
            # flat map, so the scalar path and the sweep read one source
            ca = self.crush.choose_args.get("-1")
            if ca:
                w = np.asarray(flat.weights).copy()
                algs = np.asarray(flat.algs)
                for bid, ws in ca.items():
                    bno = -1 - bid
                    if (0 <= bno < w.shape[0]
                            and algs[bno] == cmap.ALG_STRAW2):
                        w[bno, : len(ws)] = ws
                flat = dataclasses.replace(flat, weights=w)
            self._flat = flat
        return self._flat

    def _rule_fn(self, pool: PGPool):
        key = (pool.crush_rule, pool.size)
        fn = self._rule_fns.get(key)
        if fn is None:
            rule = self.crush.rules[pool.crush_rule]
            fn = cmapper.compile_rule(self._flatten(), rule.steps, pool.size,
                                      device=self.device)
            self._rule_fns[key] = fn
        return fn

    def _walk(self, pool: PGPool, pps) -> np.ndarray:
        """The rule walk over u32 seeds ``pps``: one launch on the card,
        one device-to-host copy; int32 [N, pool.size] padded with
        ITEM_NONE."""
        fn = self._rule_fn(pool)
        return fn(seeds_as_ids(pps), self.osd_weight).cpu().numpy()

    # -- placement pipeline (scalar path) ---------------------------------
    def object_to_pg(self, pool_id: int, name, nspace=b"") -> Tuple[int, int]:
        pool = self.pools[pool_id]
        ps = pool.hash_key(name, nspace)
        return (pool_id, pool.raw_pg_to_pg_ps(ps))

    def _crush_raw(self, pool: PGPool, pps: int) -> List[int]:
        """crush_do_rule's result for one seed: a firstn row without its
        padding, an indep row at its own length, holes and all."""
        row = [int(v) for v in self._walk(pool, [pps])[0]]
        n = rule_result_len(self.crush.rules[pool.crush_rule].steps,
                            pool.size)
        if n is None:
            n = len(row)
            while n and row[n - 1] == CRUSH_ITEM_NONE:
                n -= 1
        return row[:n]

    def _apply_upmap(self, pool: PGPool, pgid, raw: List[int]) -> List[int]:
        p = self.pg_upmap.get(pgid)
        if p is not None:
            ok = True
            for osd in p:
                if (
                    osd != CRUSH_ITEM_NONE
                    and 0 <= osd < self.max_osd
                    and self.osd_weight[osd] == 0
                ):
                    ok = False
                    break
            if ok:
                raw = list(p)
        q = self.pg_upmap_items.get(pgid)
        if q is not None:
            for frm, to in q:
                exists = False
                pos = -1
                for i, osd in enumerate(raw):
                    if osd == to:
                        exists = True
                        break
                    if (
                        osd == frm
                        and pos < 0
                        and not (
                            to != CRUSH_ITEM_NONE
                            and 0 <= to < self.max_osd
                            and self.osd_weight[to] == 0
                        )
                    ):
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to
        return raw

    def _raw_to_up(self, pool: PGPool, raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw if o != CRUSH_ITEM_NONE and self.is_up(o)]
        return [
            o if o != CRUSH_ITEM_NONE and self.is_up(o) else CRUSH_ITEM_NONE
            for o in raw
        ]

    def _pick_primary(self, osds: Sequence[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(
        self, seed: int, pool: PGPool, osds: List[int], primary: int
    ) -> Tuple[List[int], int]:
        aff = self.osd_primary_affinity
        if aff is None:
            return osds, primary
        if not any(
            o != CRUSH_ITEM_NONE and aff[o] != DEFAULT_PRIMARY_AFFINITY
            for o in osds
        ):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = int(aff[o])
            if a < MAX_PRIMARY_AFFINITY and (
                int(hashes.hash32_2(np.uint32(seed), np.uint32(o))) >> 16
            ) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    def _temp_acting(self, pool: PGPool, pgid) -> Tuple[List[int], int]:
        """The pg_temp / primary_temp overrides (_get_temp_osds): the
        acting set they name, and the acting primary (-1 when neither
        table has the pg)."""
        acting: List[int] = []
        for o in self.pg_temp.get(pgid, []):
            if not self.is_up(o):
                if pool.can_shift_osds():
                    continue
                acting.append(CRUSH_ITEM_NONE)
            else:
                acting.append(o)
        acting_primary = self.primary_temp.get(pgid, -1)
        if acting_primary == -1 and acting:
            acting_primary = self._pick_primary(acting)
        return acting, acting_primary

    def pg_to_up_acting(
        self, pgid: Tuple[int, int]
    ) -> Tuple[List[int], int, List[int], int]:
        """(up, up_primary, acting, acting_primary) for one pg
        (reference: OSDMap.cc:2417 _pg_to_up_acting_osds)."""
        pool_id, ps = pgid
        pool = self.pools.get(pool_id)
        if pool is None or ps >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self._temp_acting(pool, pgid)
        pps = pool.raw_pg_to_pps(ps)
        raw = self._crush_raw(pool, pps)
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    # -- the full-pool sweep ----------------------------------------------
    def map_pgs(self, pool_id: int) -> Dict[str, np.ndarray]:
        """Map ALL pgs of a pool in one launch of the rule walk.

        Returns {"raw", "up", "up_primary", "acting", "acting_primary"}
        numpy arrays: the OSDMapMapping product, minus the thread pool."""
        pool = self.pools[pool_id]
        pps = pool.pps_vector(np.arange(pool.pg_num, dtype=np.int64))
        raw = self._sweep_apply_exceptions(pool, self._walk(pool, pps))
        up, up_primary = self._sweep_up(pool, raw, pps)
        acting = up.copy()
        acting_primary = up_primary.copy()
        for pgid in self.pg_temp:
            if pgid[0] != pool_id or pgid[1] >= pool.pg_num:
                continue
            act, actp = self._temp_acting(pool, pgid)
            if act:
                row = np.full(acting.shape[1], CRUSH_ITEM_NONE,
                              dtype=np.int32)
                row[: len(act)] = act
                acting[pgid[1]] = row
                acting_primary[pgid[1]] = actp
            elif actp != -1:
                acting_primary[pgid[1]] = actp
        for pgid, p in self.primary_temp.items():
            if pgid[0] == pool_id and pgid[1] < pool.pg_num:
                acting_primary[pgid[1]] = p
        return {
            "raw": raw,
            "up": up,
            "up_primary": up_primary,
            "acting": acting,
            "acting_primary": acting_primary,
        }

    def _sweep_apply_exceptions(self, pool, raw: np.ndarray) -> np.ndarray:
        if not self.pg_upmap and not self.pg_upmap_items:
            return raw
        raw = raw.copy()
        for pgid in list(self.pg_upmap) + list(self.pg_upmap_items):
            if pgid[0] != pool.pool_id or pgid[1] >= pool.pg_num:
                continue
            row = self._apply_upmap(pool, pgid,
                                    [int(v) for v in raw[pgid[1]]])
            out = np.full(raw.shape[1], CRUSH_ITEM_NONE, dtype=np.int32)
            out[: len(row)] = row
            raw[pgid[1]] = out
        return raw

    def _sweep_up(
        self, pool: PGPool, raw: np.ndarray, pps: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized _raw_to_up_osds + primary affinity."""
        npgs, width = raw.shape
        valid = raw != CRUSH_ITEM_NONE
        inrange = valid & (raw >= 0) & (raw < self.max_osd)
        alive = np.zeros_like(valid)
        idx = np.clip(raw, 0, self.max_osd - 1)
        alive[inrange] = (
            self.osd_state_up[idx] & self.osd_state_exists[idx])[inrange]
        keep = valid & alive
        if pool.can_shift_osds():
            # stable shift-left of kept entries
            order = np.argsort(~keep, axis=1, kind="stable")
            up = np.take_along_axis(raw, order, axis=1)
            kept_sorted = np.take_along_axis(keep, order, axis=1)
            up = np.where(kept_sorted, up, CRUSH_ITEM_NONE)
        else:
            up = np.where(keep, raw, CRUSH_ITEM_NONE)

        up_valid = up != CRUSH_ITEM_NONE
        first_valid = np.argmax(up_valid, axis=1)
        any_valid = up_valid.any(axis=1)
        up_primary = np.where(
            any_valid, up[np.arange(npgs), first_valid], -1).astype(np.int32)

        if self.osd_primary_affinity is not None:
            up, up_primary = self._sweep_affinity(pool, up, up_primary, pps)
        return up.astype(np.int32), up_primary

    def _sweep_affinity(self, pool, up, up_primary, pps):
        npgs, width = up.shape
        aff = self.osd_primary_affinity
        valid = up != CRUSH_ITEM_NONE
        a = np.where(
            valid, aff[np.clip(up, 0, self.max_osd - 1)], 0
        ).astype(np.uint32)
        any_non_default = (valid & (a != DEFAULT_PRIMARY_AFFINITY)).any(axis=1)
        h = np.asarray(hashes.hash32_2(
            np.broadcast_to(pps.astype(np.uint32)[:, None], up.shape).copy(),
            np.where(valid, up, 0).astype(np.uint32))) >> 16
        accept = valid & ((a >= MAX_PRIMARY_AFFINITY) | (h < a))
        first_accept = np.argmax(accept, axis=1)
        has_accept = accept.any(axis=1)
        first_valid = np.argmax(valid, axis=1)
        pos = np.where(has_accept, first_accept, first_valid)
        has_any = valid.any(axis=1)
        rows = np.arange(npgs)
        new_primary = np.where(has_any, up[rows, pos], -1)
        use = any_non_default & has_any
        up_primary = np.where(use, new_primary, up_primary).astype(np.int32)
        if pool.can_shift_osds():
            # move the primary to the front where applied: the entries
            # before it shift one place right, as one gather
            col = np.arange(width)[None, :]
            p = np.where(use, pos, 0)[:, None]
            src = np.where(col == 0, p, np.where(col <= p, col - 1, col))
            up = np.take_along_axis(up, src, axis=1)
        return up, up_primary
