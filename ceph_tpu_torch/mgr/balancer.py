"""Upmap and crush-compat balancers — placement optimization over the
full-pool sweep.

Port of ``ceph_tpu/mgr/balancer.py``: the same moves and weight sets.
Reference role: the mgr balancer module's upmap mode
(src/pybind/mgr/balancer/module.py:644 optimize ->
OSDMap::calc_pg_upmaps) with an inversion: instead of walking PGs one
by one, every iteration recomputes the FULL pool placement with
``OSDMap.map_pgs`` (one launch of the rule-walk kernel on the map's
device), then fixes the worst deviation with pg_upmap_items
exception-table entries (src/osd/OSDMap.cc:2228 _apply_upmap consumes
them).  The counts, the deviations and the move search run on the
host, in numpy, over the sweep's rows.

Failure-domain safety: a remap target must not share its failure-domain
bucket (host, by default) with any other member of the PG's up set —
the same constraint CRUSH enforced for the original mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, OSDMap

PGId = Tuple[int, int]


@dataclasses.dataclass
class BalanceReport:
    pool_id: int
    before_stddev: float
    after_stddev: float
    moves: List[Tuple[PGId, List[Tuple[int, int]]]]

    @property
    def improved(self) -> bool:
        return self.after_stddev < self.before_stddev


class UpmapBalancer:
    def __init__(self, osdmap: OSDMap, max_deviation: float = 1.0,
                 max_moves: int = 64,
                 failure_domain_type: int = 1) -> None:
        self.osdmap = osdmap
        self.max_deviation = max_deviation
        self.max_moves = max_moves
        self.domain_of = self._osd_domains(failure_domain_type)

    def _osd_domains(self, want_type: int) -> Dict[int, int]:
        """osd -> enclosing failure-domain bucket id (crush walk)."""
        out: Dict[int, int] = {}
        parents: Dict[int, int] = {}
        for bid, b in self.osdmap.crush.buckets.items():
            for it in b.items:
                parents[it] = bid
        for osd in range(self.osdmap.max_osd):
            node = osd
            dom = None
            seen = set()
            while node in parents and node not in seen:
                seen.add(node)
                node = parents[node]
                bt = self.osdmap.crush.buckets[node].type
                if bt == want_type:
                    dom = node
                    break
            out[osd] = dom if dom is not None else osd
        return out

    # -- metrics -----------------------------------------------------------
    def _counts(self, up: np.ndarray) -> np.ndarray:
        """Per-OSD count of PG slots over the up sets (one sweep)."""
        flat = up.ravel()
        valid = (flat != CRUSH_ITEM_NONE) & (flat >= 0) & (
            flat < self.osdmap.max_osd)
        return np.bincount(flat[valid], minlength=self.osdmap.max_osd)

    def _eligible(self) -> np.ndarray:
        m = self.osdmap
        return (m.osd_state_up & m.osd_state_exists
                & (np.asarray(m.osd_weight) > 0))

    @staticmethod
    def _stddev(counts: np.ndarray, eligible: np.ndarray) -> float:
        c = counts[eligible]
        return float(np.std(c)) if len(c) else 0.0

    # -- optimization ------------------------------------------------------
    def optimize_pool(self, pool_id: int) -> BalanceReport:
        """Greedy over/under-full pairing driven by full-pool sweeps."""
        m = self.osdmap
        eligible = self._eligible()
        sweep = m.map_pgs(pool_id)
        counts = self._counts(sweep["up"])
        before = self._stddev(counts, eligible)
        moves: List[Tuple[PGId, List[Tuple[int, int]]]] = []
        target = counts[eligible].mean() if eligible.any() else 0.0

        for _ in range(self.max_moves):
            dev = np.where(eligible, counts - target, 0.0)
            donor = int(np.argmax(dev))
            if dev[donor] <= self.max_deviation:
                break
            move = self._find_move(pool_id, sweep["up"], counts, donor,
                                   eligible, target)
            if move is None:
                break
            pgid, pairs, receiver = move
            existing = list(m.pg_upmap_items.get(pgid, []))
            m.pg_upmap_items[pgid] = existing + pairs
            moves.append((pgid, pairs))
            counts[donor] -= 1
            counts[receiver] += 1
            # refresh the up rows through the real pipeline so chained
            # moves see current state
            sweep = m.map_pgs(pool_id)
            counts = self._counts(sweep["up"])
        if moves:
            m.bump_epoch()
        after = self._stddev(self._counts(m.map_pgs(pool_id)["up"]),
                             eligible)
        return BalanceReport(pool_id, before, after, moves)

    def _find_move(self, pool_id: int, up: np.ndarray,
                   counts: np.ndarray, donor: int,
                   eligible: np.ndarray, target: float):
        """Pick (pg, [(donor, receiver)]) moving one slot off `donor`
        without violating the failure domain."""
        m = self.osdmap
        under_order = np.argsort(counts + np.where(eligible, 0, 1 << 30))
        pgs_with_donor = np.nonzero((up == donor).any(axis=1))[0]
        for receiver in under_order:
            receiver = int(receiver)
            if not eligible[receiver] or receiver == donor:
                continue
            if counts[receiver] >= target:
                break  # receivers are sorted: nothing underfull left
            rdom = self.domain_of[receiver]
            for pg in pgs_with_donor:
                pgid = (pool_id, int(pg))
                row = [o for o in up[pg]
                       if o != CRUSH_ITEM_NONE and o >= 0]
                if receiver in row:
                    continue
                # failure-domain check vs the OTHER members
                if any(self.domain_of[o] == rdom
                       for o in row if o != donor):
                    continue
                return pgid, [(donor, receiver)], receiver
        return None

    def optimize(self,
                 pool_ids: Optional[Sequence[int]] = None
                 ) -> List[BalanceReport]:
        pools = (list(pool_ids) if pool_ids is not None
                 else list(self.osdmap.pools))
        return [self.optimize_pool(p) for p in pools]


class CrushCompatBalancer:
    """The balancer's crush-compat mode: optimize the COMPAT weight-set
    (choose_args id "-1") toward even PG counts, leaving client-visible
    weights and the upmap table untouched.

    Reference: src/pybind/mgr/balancer/module.py:17 (mode crush-compat)
    + :68 (do_crush_compat) — adjust leaf weight-set entries by each
    OSD's over/under-fullness, rebuild parent bucket entries as child
    sums, keep the map iff stddev improved.  The mapper consumes the
    set in bucket_straw2_choose (reference crush_choose_arg;
    ``OSDMap._flatten`` substitutes it for both the scalar path and the
    sweep).  Each iteration changes the map, so its sweep uploads a new
    device map (``crush.mapper`` caches device maps by content)."""

    def __init__(self, osdmap: OSDMap, step: float = 0.25,
                 max_iterations: int = 12) -> None:
        self.osdmap = osdmap
        self.step = step
        self.max_iterations = max_iterations

    # reuse the upmap balancer's metrics helpers
    _counts = UpmapBalancer._counts
    _eligible = UpmapBalancer._eligible
    _stddev = staticmethod(UpmapBalancer._stddev)

    def _pool_counts(self, pool_ids) -> np.ndarray:
        total = np.zeros(self.osdmap.max_osd, dtype=np.int64)
        for pid in pool_ids:
            total += self._counts(self.osdmap.map_pgs(pid)["up"])
        return total

    def _leaf_positions(self):
        """osd -> (bucket_id, position) for every OSD leaf."""
        out = {}
        for bid, b in self.osdmap.crush.buckets.items():
            for pos, it in enumerate(b.items):
                if it >= 0:
                    out[it] = (bid, pos)
        return out

    def _current_weights(self) -> Dict[int, List[int]]:
        """Working weight-set: start from the existing compat set or
        the buckets' real weights."""
        ca = self.osdmap.crush.choose_args.get("-1")
        if ca:
            return {bid: list(ws) for bid, ws in ca.items()}
        return {bid: list(b.weights)
                for bid, b in self.osdmap.crush.buckets.items()}

    def _rebuild_parents(self, ws: Dict[int, List[int]]) -> None:
        """Parent bucket entries = sum of child weight-set entries
        (bottom-up, so inter-host draws follow the adjusted leaves)."""
        buckets = self.osdmap.crush.buckets
        # children first: iterate until fixpoint over the shallow trees
        for _ in range(8):
            changed = False
            for bid, b in buckets.items():
                row = ws.get(bid)
                if row is None:
                    continue
                for pos, it in enumerate(b.items):
                    if it < 0 and it in buckets:
                        s = sum(ws.get(it, buckets[it].weights))
                        if row[pos] != s:
                            row[pos] = s
                            changed = True
            if not changed:
                break

    def optimize(self,
                 pool_ids: Optional[Sequence[int]] = None
                 ) -> BalanceReport:
        m = self.osdmap
        pools = (list(pool_ids) if pool_ids is not None
                 else list(m.pools))
        eligible = self._eligible()
        leafpos = self._leaf_positions()
        counts = self._pool_counts(pools)
        before = self._stddev(counts, eligible)
        best = before
        best_ca = (None if "-1" not in m.crush.choose_args
                   else {b: list(w) for b, w in
                         m.crush.choose_args["-1"].items()})
        ws = self._current_weights()
        for _ in range(self.max_iterations):
            target = counts[eligible].mean() if eligible.any() else 0.0
            if target <= 0:
                break
            for osd in np.nonzero(eligible)[0]:
                osd = int(osd)
                if osd not in leafpos:
                    continue
                bid, pos = leafpos[osd]
                ratio = counts[osd] / target
                w = ws[bid][pos]
                # nudge against fullness; floor keeps the OSD drawable
                neww = int(max(w * (1.0 - self.step * (ratio - 1.0)),
                               0x1000))
                ws[bid][pos] = neww
            self._rebuild_parents(ws)
            m.crush.choose_args["-1"] = {b: list(w)
                                         for b, w in ws.items()}
            m.bump_epoch()
            counts = self._pool_counts(pools)
            sd = self._stddev(counts, eligible)
            if sd < best:
                best = sd
                best_ca = {b: list(w) for b, w in ws.items()}
        # keep the best map seen (reference: balancer rejects plans
        # that don't improve the score)
        if best_ca is None:
            m.crush.choose_args.pop("-1", None)
        else:
            m.crush.choose_args["-1"] = best_ca
        m.bump_epoch()
        return BalanceReport(pools[0] if pools else -1, before, best,
                             moves=[])
