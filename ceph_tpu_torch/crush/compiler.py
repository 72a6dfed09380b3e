"""CRUSH text map compiler / decompiler.

The port's copy of ``ceph_tpu/crush/compiler.py``.  Reference:
src/crush/CrushCompiler.{h,cc} — the `crushtool -d` (decompile to text)
/ `crushtool -c` (compile from text) format:

    tunable choose_total_tries 50
    device 0 osd.0
    type 1 host
    host host0 {
        id -1
        alg straw2
        hash 0  # rjenkins1
        item osd.0 weight 1.000
    }
    rule replicated_rule {
        id 0
        type replicated
        min_size 1
        max_size 10
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }
    choose_args 0 {
        {
            bucket_id -1
            weight_set [
                [ 1.000 2.000 ]
            ]
        }
    }

Weights are 16.16 fixed-point in the map, printed as decimals with 3+
digits (the reference prints %.3f; we parse any decimal).  Hash is
always 0 (rjenkins1) — the only hash the reference ships.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.crush import map as cmap

_ALG_NAMES = {
    cmap.ALG_UNIFORM: "uniform",
    cmap.ALG_LIST: "list",
    cmap.ALG_TREE: "tree",
    cmap.ALG_STRAW: "straw",
    cmap.ALG_STRAW2: "straw2",
}
_ALG_IDS = {v: k for k, v in _ALG_NAMES.items()}

_RULE_TYPES = {1: "replicated", 3: "erasure"}
_RULE_TYPE_IDS = {v: k for k, v in _RULE_TYPES.items()}

# step name -> (op_firstn, op_indep) or single op
_SET_STEPS = {
    "set_choose_tries": cmap.OP_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": cmap.OP_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": cmap.OP_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries":
        cmap.OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": cmap.OP_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": cmap.OP_SET_CHOOSELEAF_STABLE,
}
_SET_STEP_NAMES = {v: k for k, v in _SET_STEPS.items()}

_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable")


class CompileError(ValueError):
    pass


def _w_to_f(w: int) -> str:
    return f"{w / 0x10000:.5f}"


def _f_to_w(s: str) -> int:
    return int(round(float(s) * 0x10000))


# ---------------------------------------------------------------------------
# decompile
# ---------------------------------------------------------------------------

def decompile(cm: cmap.CrushMap) -> str:
    names = dict(cm.bucket_names)
    for bid in sorted(cm.buckets, reverse=True):
        names.setdefault(bid, f"bucket{-bid}")
    type_names = dict(cm.type_names)
    for b in cm.buckets.values():
        type_names.setdefault(b.type, f"type{b.type}")

    out: List[str] = ["# begin crush map"]
    t = cm.tunables
    for tn in _TUNABLES:
        out.append(f"tunable {tn} {getattr(t, tn)}")
    out.append("")
    out.append("# devices")
    for dev in range(cm.max_devices):
        out.append(f"device {dev} osd.{dev}")
    out.append("")
    out.append("# types")
    for tid in sorted(type_names):
        out.append(f"type {tid} {type_names[tid]}")
    out.append("")
    out.append("# buckets")

    def item_name(i: int) -> str:
        return f"osd.{i}" if i >= 0 else names[i]

    # children before parents (the reference emits leaves-up so the
    # compiler sees every name before its first use)
    emitted = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted:
            return
        b = cm.buckets[bid]
        for it in b.items:
            if it < 0:
                emit_bucket(it)
        emitted.add(bid)
        out.append(f"{type_names[b.type]} {names[bid]} {{")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily")
        out.append(f"\t# weight {_w_to_f(b.weight)}")
        out.append(f"\talg {_ALG_NAMES[b.alg]}")
        out.append("\thash 0\t# rjenkins1")
        for it, w in zip(b.items, b.weights):
            out.append(f"\titem {item_name(it)} weight {_w_to_f(w)}")
        out.append("}")

    for bid in sorted(cm.buckets, reverse=True):
        emit_bucket(bid)
    out.append("")
    out.append("# rules")
    for rid, r in enumerate(cm.rules):
        out.append(f"rule {r.name} {{")
        out.append(f"\tid {rid}")  # position IS the id (dense invariant)
        out.append(f"\ttype {_RULE_TYPES.get(r.type, 'replicated')}")
        out.append(f"\tmin_size {r.min_size}")
        out.append(f"\tmax_size {r.max_size}")
        for op, a1, a2 in r.steps:
            if op == cmap.OP_TAKE:
                out.append(f"\tstep take {item_name(a1)}")
            elif op == cmap.OP_EMIT:
                out.append("\tstep emit")
            elif op in (cmap.OP_CHOOSE_FIRSTN, cmap.OP_CHOOSE_INDEP,
                        cmap.OP_CHOOSELEAF_FIRSTN,
                        cmap.OP_CHOOSELEAF_INDEP):
                kind = ("chooseleaf"
                        if op in (cmap.OP_CHOOSELEAF_FIRSTN,
                                  cmap.OP_CHOOSELEAF_INDEP) else "choose")
                mode = ("firstn"
                        if op in (cmap.OP_CHOOSE_FIRSTN,
                                  cmap.OP_CHOOSELEAF_FIRSTN) else "indep")
                out.append(f"\tstep {kind} {mode} {a1} type "
                           f"{type_names[a2]}")
            elif op in _SET_STEP_NAMES:
                out.append(f"\tstep {_SET_STEP_NAMES[op]} {a1}")
            else:
                raise CompileError(f"cannot decompile step op {op}")
        out.append("}")
    if cm.choose_args:
        out.append("")
        out.append("# choose_args")
        for ca_name in sorted(cm.choose_args):
            out.append(f"choose_args {ca_name} {{")
            for bid in sorted(cm.choose_args[ca_name], reverse=True):
                ws = cm.choose_args[ca_name][bid]
                out.append("\t{")
                out.append(f"\t\tbucket_id {bid}")
                out.append("\t\tweight_set [")
                out.append("\t\t\t[ "
                           + " ".join(_w_to_f(w) for w in ws) + " ]")
                out.append("\t\t]")
                out.append("\t}")
            out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------

def _tokenize(text: str) -> List[str]:
    toks: List[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        line = line.replace("{", " { ").replace("}", " } ")
        line = line.replace("[", " [ ").replace("]", " ] ")
        toks.extend(line.split())
    return toks


def compile_text(text: str) -> cmap.CrushMap:
    toks = _tokenize(text)
    pos = 0

    def peek() -> Optional[str]:
        return toks[pos] if pos < len(toks) else None

    def take(expect: Optional[str] = None) -> str:
        nonlocal pos
        if pos >= len(toks):
            raise CompileError("unexpected end of map")
        tok = toks[pos]
        pos += 1
        if expect is not None and tok != expect:
            raise CompileError(f"expected {expect!r}, got {tok!r}")
        return tok

    cm = cmap.CrushMap()
    type_ids: Dict[str, int] = {}
    name_ids: Dict[str, int] = {}
    rules: List[cmap.Rule] = []
    max_device = -1
    rule_count = 0

    def resolve_item(name: str) -> int:
        if name.startswith("osd."):
            return int(name[4:])
        if name not in name_ids:
            raise CompileError(f"unknown bucket {name!r}")
        return name_ids[name]

    while (tok := peek()) is not None:
        if tok == "tunable":
            take()
            tn, val = take(), take()
            if tn == "straw_calc_version":
                cm.tunables.straw_calc_version = int(val)
            elif tn in _TUNABLES:
                setattr(cm.tunables, tn, int(val))
            # unknown tunables are ignored (reference warns)
        elif tok == "device":
            take()
            dev = int(take())
            take()  # osd.N name
            max_device = max(max_device, dev)
            if peek() == "class":  # device classes: parsed, not modeled
                take()
                take()
        elif tok == "type":
            take()
            tid = int(take())
            cm.type_names[tid] = (tname := take())
            type_ids[tname] = tid
        elif tok == "rule":
            take()
            r = _parse_rule(take, type_ids, resolve_item, rule_count)
            rule_count += 1
            rules.append(r)
        elif tok == "choose_args":
            take()
            ca_name = take()
            cm.choose_args[ca_name] = _parse_choose_args(take, peek)
        elif tok in type_ids or tok in ("host", "root", "rack", "row",
                                        "datacenter", "chassis", "pod",
                                        "region", "zone", "osd"):
            # bucket block: "<type-name> <name> { ... }"
            tname = take()
            bname = take()
            bid, alg, items, weights = _parse_bucket(take, peek,
                                                     resolve_item)
            btype = type_ids.get(tname)
            if btype is None:
                # type used before declaration: allocate one
                btype = max(list(cm.type_names) + [0]) + 1
                cm.type_names[btype] = tname
                type_ids[tname] = btype
            if bid is None:
                bid = cm._next_id
            cm.add_bucket(alg, btype, items, weights, id=bid)
            cm.bucket_names[bid] = bname
            name_ids[bname] = bid
        else:
            raise CompileError(f"unexpected token {tok!r}")
    # pools index rules by POSITION (osdmap pipeline / reference's
    # rule_id==index invariant since luminous): order by declared id and
    # require the ids to be dense
    rules.sort(key=lambda r: r.ruleset)
    ids = [r.ruleset for r in rules]
    if ids != list(range(len(rules))):
        raise CompileError(f"rule ids must be dense 0..N-1, got {ids}")
    for r in rules:
        cm.add_rule(r)
    return cm


def _parse_bucket(take, peek, resolve_item
                  ) -> Tuple[Optional[int], int, List[int], List[int]]:
    take("{")
    bid: Optional[int] = None
    alg = cmap.ALG_STRAW2
    entries: List[Tuple[int, int, int]] = []  # (pos or -1, item, weight)
    while (tok := take()) != "}":
        if tok == "id":
            val = take()
            if val == "class":  # "id -2 class hdd" shadow ids
                take()
            else:
                bid = int(val) if bid is None else bid
        elif tok == "alg":
            alg = _ALG_IDS[take()]
        elif tok == "hash":
            take()  # always rjenkins1
        elif tok == "item":
            name = take()
            item = resolve_item(name)
            w = 0x10000
            pos = -1
            # weight/pos are optional per the reference CrushCompiler
            # grammar ("item osd.N" alone is legal) — peek, don't eat
            if peek() == "weight":
                take()
                w = _f_to_w(take())
            if peek() == "pos":
                take()
                pos = int(take())
            entries.append((pos, item, w))
        elif tok == "weight":  # bucket-level weight comment form
            take()
        else:
            raise CompileError(f"unexpected bucket token {tok!r}")
    # honor explicit positions (item order feeds CRUSH placement —
    # reference CrushCompiler parse_bucket item_id/pos bookkeeping):
    # positioned items claim their slot, the rest fill gaps in file order
    n = len(entries)
    slots: List[Optional[Tuple[int, int]]] = [None] * n
    for pos, item, w in entries:
        if pos >= 0:
            if pos >= n or slots[pos] is not None:
                raise CompileError(f"bad item pos {pos}")
            slots[pos] = (item, w)
    free = iter([i for i in range(n) if slots[i] is None])
    for pos, item, w in entries:
        if pos < 0:
            slots[next(free)] = (item, w)
    items = [s[0] for s in slots]  # type: ignore[index]
    weights = [s[1] for s in slots]  # type: ignore[index]
    return bid, alg, items, weights


def _parse_rule(take, type_ids, resolve_item, default_id) -> cmap.Rule:
    name = take()
    take("{")
    rid = default_id
    rtype = 1
    min_size, max_size = 1, 32
    steps: List[Tuple[int, int, int]] = []
    while (tok := take()) != "}":
        if tok in ("id", "ruleset"):
            rid = int(take())
        elif tok == "type":
            rtype = _RULE_TYPE_IDS.get(take(), 1)
        elif tok == "min_size":
            min_size = int(take())
        elif tok == "max_size":
            max_size = int(take())
        elif tok == "step":
            op = take()
            if op == "take":
                steps.append((cmap.OP_TAKE, resolve_item(take()), 0))
            elif op == "emit":
                steps.append((cmap.OP_EMIT, 0, 0))
            elif op in ("choose", "chooseleaf"):
                mode = take()
                num = int(take())
                take("type")
                tname = take()
                tid = type_ids.get(tname, 0)
                if op == "choose":
                    o = (cmap.OP_CHOOSE_FIRSTN if mode == "firstn"
                         else cmap.OP_CHOOSE_INDEP)
                else:
                    o = (cmap.OP_CHOOSELEAF_FIRSTN if mode == "firstn"
                         else cmap.OP_CHOOSELEAF_INDEP)
                steps.append((o, num, tid))
            elif op in _SET_STEPS:
                steps.append((_SET_STEPS[op], int(take()), 0))
            else:
                raise CompileError(f"unknown rule step {op!r}")
        else:
            raise CompileError(f"unexpected rule token {tok!r}")
    return cmap.Rule(name=name, steps=steps, ruleset=rid, type=rtype,
                     min_size=min_size, max_size=max_size)


def _parse_choose_args(take, peek) -> Dict[int, List[int]]:
    take("{")
    out: Dict[int, List[int]] = {}
    while peek() == "{":
        take("{")
        bid = None
        ws: List[int] = []
        while (tok := take()) != "}":
            if tok == "bucket_id":
                bid = int(take())
            elif tok == "weight_set":
                take("[")
                while peek() == "[":
                    take("[")
                    ws = []
                    while peek() != "]":
                        ws.append(_f_to_w(take()))
                    take("]")
                take("]")
            elif tok == "ids":  # id remapping: parsed, not modeled
                take("[")
                while take() != "]":
                    pass
        if bid is not None:
            out[bid] = ws
    take("}")
    return out
