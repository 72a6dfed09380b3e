"""Wire/disk codec for CrushMap + OSDMap.

Reference role: OSDMap::encode/decode + CrushWrapper::encode
(src/osd/OSDMap.cc, src/crush/CrushWrapper.cc) — the serialized cluster
map the mon commits through Paxos and every daemon/client consumes.
Versioned frames (core.encoding) so map formats can evolve.

Port of ``ceph_tpu/osd/map_codec.py``: the same bytes.  A decoded
OSDMap walks its rules on ``device`` (None: CUDA; ``"cpu"``: the plain
walk).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool


def encode_crush(e: Encoder, cm: cmap.CrushMap) -> None:
    # v2 adds bucket_names + choose_args (compat 1: old decoders skip
    # the trailing fields via the frame length)
    e.start(2, 1)
    t = cm.tunables
    e.u32(t.choose_total_tries).u32(t.choose_local_tries)
    e.u32(t.choose_local_fallback_tries)
    e.u32(t.chooseleaf_descend_once).u32(t.chooseleaf_vary_r)
    e.u32(t.chooseleaf_stable)

    def enc_bucket(enc: Encoder, b: cmap.Bucket) -> None:
        enc.u8(b.alg)
        enc.s32(b.type)
        enc.seq(b.items, lambda en2, i: en2.s32(i))
        enc.seq(b.weights, lambda en2, w: en2.u32(w))

    e.mapping(cm.buckets, lambda enc, k: enc.s32(k), enc_bucket)

    def enc_rule(enc: Encoder, r: cmap.Rule) -> None:
        enc.string(r.name)
        enc.u8(r.type)
        enc.seq(r.steps, lambda en2, s: (
            en2.s32(s[0]), en2.s32(s[1]), en2.s32(s[2])))
        # v2: rule size bounds + ruleset id (previously lost on decode)
        enc.s32(r.ruleset).s32(r.min_size).s32(r.max_size)

    e.seq(cm.rules, enc_rule)
    e.mapping(cm.type_names, lambda enc, k: enc.s32(k),
              lambda enc, v: enc.string(v))
    e.mapping(cm.bucket_names, lambda enc, k: enc.s32(k),
              lambda enc, v: enc.string(v))
    e.mapping(
        cm.choose_args,
        lambda enc, k: enc.string(k),
        lambda enc, v: enc.mapping(
            v, lambda e2, bid: e2.s32(bid),
            lambda e2, ws: e2.seq(ws, lambda e3, w: e3.u32(w))),
    )
    e.finish()


def decode_crush(d: Decoder) -> cmap.CrushMap:
    v = d.start(1)
    t = cmap.Tunables(
        choose_total_tries=d.u32(),
        choose_local_tries=d.u32(),
        choose_local_fallback_tries=d.u32(),
        chooseleaf_descend_once=d.u32(),
        chooseleaf_vary_r=d.u32(),
        chooseleaf_stable=d.u32(),
    )
    cm = cmap.CrushMap(t)
    # bucket id is the mapping key; re-attach while decoding values
    raw = d.mapping(
        lambda dd: dd.s32(),
        lambda dd: (dd.u8(), dd.s32(), dd.seq(lambda x: x.s32()),
                    dd.seq(lambda x: x.u32())),
    )
    for bid, (alg, btype, items, weights) in raw.items():
        cm.buckets[bid] = cmap.Bucket(bid, alg, btype, items, weights)
    if cm.buckets:
        cm._next_id = min(cm.buckets) - 1

    def dec_rule(dd: Decoder) -> cmap.Rule:
        name = dd.string()
        rtype = dd.u8()
        steps = dd.seq(lambda x: (x.s32(), x.s32(), x.s32()))
        r = cmap.Rule(name=name, steps=steps, type=rtype)
        if v >= 2:
            r.ruleset = dd.s32()
            r.min_size = dd.s32()
            r.max_size = dd.s32()
        return r

    cm.rules = d.seq(dec_rule)
    cm.type_names = d.mapping(lambda dd: dd.s32(), lambda dd: dd.string())
    if v >= 2:
        cm.bucket_names = d.mapping(lambda dd: dd.s32(),
                                    lambda dd: dd.string())
        cm.choose_args = d.mapping(
            lambda dd: dd.string(),
            lambda dd: dd.mapping(lambda d2: d2.s32(),
                                  lambda d2: d2.seq(lambda d3: d3.u32())),
        )
    d.end()
    return cm


def _enc_pool(e: Encoder, p: PGPool) -> None:
    e.start(2, 1)  # v2 adds hit-set params; v1 blobs still decode
    e.s64(p.pool_id).u8(p.pool_type).u32(p.size).u32(p.min_size)
    e.u32(p.pg_num).u32(p.pgp_num).u32(p.crush_rule).u32(p.flags)
    e.string(p.object_hash).string(p.erasure_code_profile)
    e.string(p.name)
    # v2: hit-set tracking params
    e.u32(p.hit_set_count).u64(int(p.hit_set_period * 1000))
    e.u32(p.hit_set_target_size).u64(int(p.hit_set_fpp * 1e9))
    e.finish()


def _dec_pool(d: Decoder) -> PGPool:
    v = d.start(1)
    p = PGPool(
        pool_id=d.s64(), pool_type=d.u8(), size=d.u32(), min_size=d.u32(),
        pg_num=d.u32(), pgp_num=d.u32(), crush_rule=d.u32(), flags=d.u32(),
        object_hash=d.string(), erasure_code_profile=d.string(),
        name=d.string(),
    )
    if v >= 2:
        p.hit_set_count = d.u32()
        p.hit_set_period = d.u64() / 1000.0
        p.hit_set_target_size = d.u32()
        p.hit_set_fpp = d.u64() / 1e9
    d.end()
    return p


def _enc_pgid_key(e: Encoder, k: Tuple[int, int]) -> None:
    e.s64(k[0])
    e.u32(k[1])


def _dec_pgid_key(d: Decoder) -> Tuple[int, int]:
    return (d.s64(), d.u32())


def encode_osdmap(m: OSDMap) -> bytes:
    e = Encoder()
    e.start(1, 1)
    e.u32(m.epoch).u32(m.max_osd)
    encode_crush(e, m.crush)
    e.blob(np.asarray(m.osd_state_up, dtype=np.uint8).tobytes())
    e.blob(np.asarray(m.osd_state_exists, dtype=np.uint8).tobytes())
    e.blob(np.asarray(m.osd_weight, dtype="<u4").tobytes())
    e.optional(
        m.osd_primary_affinity,
        lambda enc, a: enc.blob(np.asarray(a, dtype="<u4").tobytes()),
    )
    e.mapping(m.pools, lambda enc, k: enc.s64(k),
              lambda enc, p: _enc_pool(enc, p))
    e.mapping(m.pg_upmap, _enc_pgid_key,
              lambda enc, v: enc.seq(v, lambda en2, o: en2.s32(o)))
    e.mapping(m.pg_upmap_items, _enc_pgid_key,
              lambda enc, v: enc.seq(v, lambda en2, fp: (
                  en2.s32(fp[0]), en2.s32(fp[1]))))
    e.mapping(m.pg_temp, _enc_pgid_key,
              lambda enc, v: enc.seq(v, lambda en2, o: en2.s32(o)))
    e.mapping(m.primary_temp, _enc_pgid_key, lambda enc, v: enc.s32(v))
    e.mapping(m.osd_addrs,
              lambda enc, k: enc.s32(k),
              lambda enc, a: (enc.string(a[0]), enc.u32(a[1])))
    e.mapping(m.osd_hb_addrs,
              lambda enc, k: enc.s32(k),
              lambda enc, a: (enc.string(a[0]), enc.u32(a[1])))
    e.finish()
    return e.bytes()


def decode_osdmap(data: bytes, device=None) -> OSDMap:
    d = Decoder(data)
    d.start(1)
    epoch = d.u32()
    max_osd = d.u32()
    cm = decode_crush(d)
    m = OSDMap(cm, max_osd=max_osd, device=device)
    m.epoch = epoch
    m.osd_state_up = np.frombuffer(
        d.blob(), dtype=np.uint8).astype(bool).copy()
    m.osd_state_exists = np.frombuffer(
        d.blob(), dtype=np.uint8).astype(bool).copy()
    m.osd_weight = np.frombuffer(d.blob(), dtype="<u4").copy()
    m.osd_primary_affinity = d.optional(
        lambda dd: np.frombuffer(dd.blob(), dtype="<u4").copy())
    m.pools = d.mapping(lambda dd: dd.s64(), _dec_pool)
    m.pg_upmap = d.mapping(_dec_pgid_key,
                           lambda dd: dd.seq(lambda x: x.s32()))
    m.pg_upmap_items = d.mapping(
        _dec_pgid_key, lambda dd: dd.seq(lambda x: (x.s32(), x.s32())))
    m.pg_temp = d.mapping(_dec_pgid_key,
                          lambda dd: dd.seq(lambda x: x.s32()))
    m.primary_temp = d.mapping(_dec_pgid_key, lambda dd: dd.s32())
    m.osd_addrs = d.mapping(lambda dd: dd.s32(),
                            lambda dd: (dd.string(), dd.u32()))
    m.osd_hb_addrs = d.mapping(lambda dd: dd.s32(),
                               lambda dd: (dd.string(), dd.u32()))
    d.end()
    return m
