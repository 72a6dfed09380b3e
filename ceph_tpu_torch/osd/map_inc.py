"""OSDMap incremental deltas.

Reference role: OSDMap::Incremental (src/osd/OSDMap.h; applied at
OSDMap::apply_incremental, produced by OSDMonitor's pending_inc).  A map
change ships O(delta) bytes — osd state flips, weight changes, pool
edits, pg_temp/upmap entries — instead of the O(cluster) full map; the
CRUSH tree rides along as a full blob only when it actually changed
(the reference Incremental carries `crush` the same way).

The diff is computed generically (old map vs mutated map) so every
mutation site stays a plain "mutate the pending map" function, exactly
like the reference's pending_inc discipline.

Port of ``ceph_tpu/osd/map_inc.py``: the same bytes.  A map made from
another (``clone_map``, ``Incremental.apply``, ``decode_value`` on a
base) keeps that map's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.osd import map_codec
from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool

PGId = Tuple[int, int]
Addr = Tuple[str, int]

# committed-value / wire tags
FULL_TAG = 0
INC_TAG = 1


@dataclasses.dataclass
class Incremental:
    epoch: int = 0        # the epoch this delta produces
    prev_epoch: int = 0   # must match the base map
    new_max_osd: int = -1
    crush: bytes = b""    # re-encoded crush map when changed
    new_up: List[int] = dataclasses.field(default_factory=list)
    new_down: List[int] = dataclasses.field(default_factory=list)
    # address book deltas; ("", 0) removes the entry
    new_addrs: Dict[int, Addr] = dataclasses.field(default_factory=dict)
    new_hb_addrs: Dict[int, Addr] = dataclasses.field(default_factory=dict)
    new_weights: Dict[int, int] = dataclasses.field(default_factory=dict)
    new_exists: Dict[int, bool] = dataclasses.field(default_factory=dict)
    new_primary_affinity: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    new_pools: Dict[int, PGPool] = dataclasses.field(default_factory=dict)
    removed_pools: List[int] = dataclasses.field(default_factory=list)
    # empty list / -1 value = remove the entry
    new_pg_temp: Dict[PGId, List[int]] = dataclasses.field(
        default_factory=dict)
    new_primary_temp: Dict[PGId, int] = dataclasses.field(
        default_factory=dict)
    new_pg_upmap: Dict[PGId, List[int]] = dataclasses.field(
        default_factory=dict)
    new_pg_upmap_items: Dict[PGId, List[Tuple[int, int]]] = (
        dataclasses.field(default_factory=dict))

    # -- codec -------------------------------------------------------------
    def encode(self) -> bytes:
        e = Encoder()
        e.start(1, 1)
        e.u32(self.epoch).u32(self.prev_epoch).s32(self.new_max_osd)
        e.blob(self.crush)
        e.seq(self.new_up, lambda enc, o: enc.s32(o))
        e.seq(self.new_down, lambda enc, o: enc.s32(o))
        for book in (self.new_addrs, self.new_hb_addrs):
            e.mapping(book, lambda enc, k: enc.s32(k),
                      lambda enc, a: (enc.string(a[0]), enc.u32(a[1])))
        e.mapping(self.new_weights, lambda enc, k: enc.s32(k),
                  lambda enc, w: enc.u32(w))
        e.mapping(self.new_exists, lambda enc, k: enc.s32(k),
                  lambda enc, b: enc.boolean(b))
        e.mapping(self.new_primary_affinity, lambda enc, k: enc.s32(k),
                  lambda enc, a: enc.u32(a))
        e.mapping(self.new_pools, lambda enc, k: enc.s64(k),
                  lambda enc, p: map_codec._enc_pool(enc, p))
        e.seq(self.removed_pools, lambda enc, p: enc.s64(p))
        e.mapping(self.new_pg_temp, map_codec._enc_pgid_key,
                  lambda enc, v: enc.seq(v, lambda e2, o: e2.s32(o)))
        e.mapping(self.new_primary_temp, map_codec._enc_pgid_key,
                  lambda enc, v: enc.s32(v))
        e.mapping(self.new_pg_upmap, map_codec._enc_pgid_key,
                  lambda enc, v: enc.seq(v, lambda e2, o: e2.s32(o)))
        e.mapping(self.new_pg_upmap_items, map_codec._enc_pgid_key,
                  lambda enc, v: enc.seq(
                      v, lambda e2, fp: (e2.s32(fp[0]), e2.s32(fp[1]))))
        e.finish()
        return e.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Incremental":
        d = Decoder(data)
        d.start(1)
        inc = cls(epoch=d.u32(), prev_epoch=d.u32(), new_max_osd=d.s32(),
                  crush=d.blob())
        inc.new_up = d.seq(lambda dd: dd.s32())
        inc.new_down = d.seq(lambda dd: dd.s32())
        inc.new_addrs = d.mapping(lambda dd: dd.s32(),
                                  lambda dd: (dd.string(), dd.u32()))
        inc.new_hb_addrs = d.mapping(lambda dd: dd.s32(),
                                     lambda dd: (dd.string(), dd.u32()))
        inc.new_weights = d.mapping(lambda dd: dd.s32(), lambda dd: dd.u32())
        inc.new_exists = d.mapping(lambda dd: dd.s32(),
                                   lambda dd: dd.boolean())
        inc.new_primary_affinity = d.mapping(lambda dd: dd.s32(),
                                             lambda dd: dd.u32())
        inc.new_pools = d.mapping(lambda dd: dd.s64(), map_codec._dec_pool)
        inc.removed_pools = d.seq(lambda dd: dd.s64())
        inc.new_pg_temp = d.mapping(
            map_codec._dec_pgid_key, lambda dd: dd.seq(lambda x: x.s32()))
        inc.new_primary_temp = d.mapping(map_codec._dec_pgid_key,
                                         lambda dd: dd.s32())
        inc.new_pg_upmap = d.mapping(
            map_codec._dec_pgid_key, lambda dd: dd.seq(lambda x: x.s32()))
        inc.new_pg_upmap_items = d.mapping(
            map_codec._dec_pgid_key,
            lambda dd: dd.seq(lambda x: (x.s32(), x.s32())))
        d.end()
        return inc

    # -- application -------------------------------------------------------
    def apply(self, base: OSDMap) -> OSDMap:
        """base (at prev_epoch) -> a NEW map at self.epoch."""
        if base.epoch != self.prev_epoch:
            raise ValueError(
                f"incremental for e{self.prev_epoch}->e{self.epoch} "
                f"cannot apply to e{base.epoch}"
            )
        m = clone_map(base)
        if self.crush:
            m.crush = map_codec.decode_crush(Decoder(self.crush))
            m._flat = None
            m._rule_fns.clear()
        if self.new_max_osd >= 0 and self.new_max_osd != m.max_osd:
            _resize(m, self.new_max_osd)
        for osd in self.new_up:
            m.osd_state_up[osd] = True
            m.osd_state_exists[osd] = True
        for osd in self.new_down:
            m.osd_state_up[osd] = False
        for book, changes in ((m.osd_addrs, self.new_addrs),
                              (m.osd_hb_addrs, self.new_hb_addrs)):
            for osd, a in changes.items():
                if a == ("", 0):
                    book.pop(osd, None)
                else:
                    book[osd] = a
        for osd, w in self.new_weights.items():
            m.osd_weight[osd] = w
        for osd, ex in self.new_exists.items():
            m.osd_state_exists[osd] = ex
        if self.new_primary_affinity:
            if m.osd_primary_affinity is None:
                m.osd_primary_affinity = np.full(
                    m.max_osd, 0x10000, dtype=np.uint32)
            for osd, a in self.new_primary_affinity.items():
                m.osd_primary_affinity[osd] = a
        for pid, pool in self.new_pools.items():
            m.pools[pid] = pool
        for pid in self.removed_pools:
            m.pools.pop(pid, None)
        _apply_entries(m.pg_temp, self.new_pg_temp, empty=list)
        for pgid, p in self.new_primary_temp.items():
            if p < 0:
                m.primary_temp.pop(pgid, None)
            else:
                m.primary_temp[pgid] = p
        _apply_entries(m.pg_upmap, self.new_pg_upmap, empty=list)
        _apply_entries(m.pg_upmap_items, self.new_pg_upmap_items,
                       empty=list)
        m.epoch = self.epoch
        return m


def _resize(m: OSDMap, new_max: int) -> None:
    def grow(arr, fill, dtype):
        out = np.full(new_max, fill, dtype=dtype)
        out[: min(len(arr), new_max)] = arr[: min(len(arr), new_max)]
        return out

    m.osd_state_up = grow(m.osd_state_up, False, bool)
    m.osd_state_exists = grow(m.osd_state_exists, False, bool)
    m.osd_weight = grow(m.osd_weight, 0x10000, np.uint32)
    if m.osd_primary_affinity is not None:
        m.osd_primary_affinity = grow(
            m.osd_primary_affinity, 0x10000, np.uint32)
    m.max_osd = new_max


def _apply_entries(target: Dict, changes: Dict, empty) -> None:
    for k, v in changes.items():
        if not v:
            target.pop(k, None)
        else:
            target[k] = v


def clone_map(m: OSDMap) -> OSDMap:
    """Deep copy via the canonical codec (identical to the monitor's
    pending-map clone), on m's device."""
    return map_codec.decode_osdmap(map_codec.encode_osdmap(m),
                                   device=m.device)


def crush_bytes(m: OSDMap) -> bytes:
    e = Encoder()
    map_codec.encode_crush(e, m.crush)
    return e.bytes()


def diff_maps(old: OSDMap, new: OSDMap,
              old_crush: Optional[bytes] = None,
              new_crush: Optional[bytes] = None) -> Incremental:
    """Generic pending-inc construction: compare two maps field-wise.
    Callers diffing a chain can pass cached crush encodings to avoid
    re-encoding the tree on every delta."""
    inc = Incremental(epoch=new.epoch, prev_epoch=old.epoch)
    if old_crush is None:
        old_crush = crush_bytes(old)
    if new_crush is None:
        new_crush = crush_bytes(new)
    if old_crush != new_crush:
        inc.crush = new_crush
    if new.max_osd != old.max_osd:
        inc.new_max_osd = new.max_osd
    n = min(old.max_osd, new.max_osd)
    for osd in range(new.max_osd):
        old_up = bool(old.osd_state_up[osd]) if osd < n else False
        new_up = bool(new.osd_state_up[osd])
        if new_up and not old_up:
            inc.new_up.append(osd)
        elif old_up and not new_up:
            inc.new_down.append(osd)
        old_w = int(old.osd_weight[osd]) if osd < n else 0x10000
        if int(new.osd_weight[osd]) != old_w:
            inc.new_weights[osd] = int(new.osd_weight[osd])
        old_ex = bool(old.osd_state_exists[osd]) if osd < n else True
        if bool(new.osd_state_exists[osd]) != old_ex:
            inc.new_exists[osd] = bool(new.osd_state_exists[osd])
        old_a = (int(old.osd_primary_affinity[osd])
                 if old.osd_primary_affinity is not None and osd < n
                 else 0x10000)
        new_a = (int(new.osd_primary_affinity[osd])
                 if new.osd_primary_affinity is not None else 0x10000)
        if new_a != old_a:
            inc.new_primary_affinity[osd] = new_a
    for book_old, book_new, out in (
            (old.osd_addrs, new.osd_addrs, inc.new_addrs),
            (old.osd_hb_addrs, new.osd_hb_addrs, inc.new_hb_addrs)):
        for osd, a in book_new.items():
            if book_old.get(osd) != a:
                out[osd] = a
        for osd in book_old:
            if osd not in book_new:
                out[osd] = ("", 0)
    for pid, pool in new.pools.items():
        if pid not in old.pools or _pool_bytes(pool) != _pool_bytes(
                old.pools[pid]):
            inc.new_pools[pid] = pool
    inc.removed_pools = [p for p in old.pools if p not in new.pools]
    _diff_entries(old.pg_temp, new.pg_temp, inc.new_pg_temp, [])
    _diff_entries(old.primary_temp, new.primary_temp,
                  inc.new_primary_temp, -1)
    _diff_entries(old.pg_upmap, new.pg_upmap, inc.new_pg_upmap, [])
    _diff_entries(old.pg_upmap_items, new.pg_upmap_items,
                  inc.new_pg_upmap_items, [])
    return inc


def _pool_bytes(p: PGPool) -> bytes:
    e = Encoder()
    map_codec._enc_pool(e, p)
    return e.bytes()


def _diff_entries(old: Dict, new: Dict, out: Dict, removed_sentinel):
    for k, v in new.items():
        if old.get(k) != v:
            out[k] = v
    for k in old:
        if k not in new:
            out[k] = removed_sentinel


# -- committed-value / wire framing ---------------------------------------

def encode_full_value(m: OSDMap) -> bytes:
    return bytes([FULL_TAG]) + map_codec.encode_osdmap(m)


def encode_inc_value(inc: Incremental) -> bytes:
    return bytes([INC_TAG]) + inc.encode()


def decode_value(value: bytes, base: Optional[OSDMap],
                 device=None) -> OSDMap:
    """Committed value -> map.  Raises NeedFullMap when an incremental
    has no matching base (the caller must catch up).  A full map lands
    on ``device`` (None: CUDA); an applied one keeps its base's."""
    tag = value[0]
    if tag == FULL_TAG:
        return map_codec.decode_osdmap(value[1:], device=device)
    inc = Incremental.decode(value[1:])
    if base is None or base.epoch != inc.prev_epoch:
        raise NeedFullMap(
            f"inc e{inc.prev_epoch}->e{inc.epoch} vs base "
            f"e{base.epoch if base else None}"
        )
    return inc.apply(base)


class NeedFullMap(Exception):
    pass
