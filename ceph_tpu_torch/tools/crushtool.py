"""crushtool — build, test and inspect CRUSH maps, on the card.

Port of ``tools/crushtool.py`` (reference: src/tools/crushtool.cc:112-218
for --build/--test and src/crush/CrushTester.cc:472 for the placement
distribution test).  The --test sweep is one launch of the rule-walk
kernel over the whole x range (``crush.mapper.compile_rule``), on CUDA
unless ``--device cpu`` asks for the plain version.

Binary map files (``-i``, and ``-o`` outside ``-d``) are the map
codec's bytes (``osd/map_codec.py``), the reference tool's format.

Examples:
  python -m ceph_tpu_torch.tools.crushtool --build --num_osds 64 \\
      host straw2 4 root straw2 0 --test --num-rep 3 --min-x 0 \\
      --max-x 9999 --show-statistics --show-utilization
  python -m ceph_tpu_torch.tools.crushtool -c map.txt -o map.bin
  python -m ceph_tpu_torch.tools.crushtool -d -i map.bin -o map2.txt
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.crush import mapper
from ceph_tpu_torch.osd.map_codec import decode_crush, encode_crush

ITEM_NONE = cmap.ITEM_NONE


def build_map(num_osds: int, layers) -> cmap.CrushMap:
    """--build: bottom-up layers of (name, alg, size); size 0 = one
    bucket over everything below (reference crushtool.cc --build)."""
    m = cmap.CrushMap()
    alg_by_name = {"uniform": cmap.ALG_UNIFORM, "list": cmap.ALG_LIST,
                   "tree": cmap.ALG_TREE, "straw": cmap.ALG_STRAW,
                   "straw2": cmap.ALG_STRAW2}
    items = list(range(num_osds))
    weights = [0x10000] * num_osds
    type_id = 0
    for name, alg_name, size in layers:
        type_id += 1
        m.type_names[type_id] = name
        alg = alg_by_name[alg_name]
        if size == 0:
            groups = [items]
        else:
            groups = [items[i:i + size] for i in range(0, len(items), size)]
        new_items, new_weights = [], []
        at = 0
        for g in groups:
            w = weights[at:at + len(g)]
            bid = m.add_bucket(alg, type_id, g, w)
            new_items.append(bid)
            new_weights.append(sum(w))
            at += len(g)
        items, weights = new_items, new_weights
    return m


def run_test(m: cmap.CrushMap, args, device=None) -> dict:
    rule_no = args.rule
    if rule_no >= len(m.rules):
        m.add_rule(cmap.Rule("test", [
            (cmap.OP_TAKE, min(m.buckets), 0),
            (cmap.OP_CHOOSELEAF_FIRSTN, args.num_rep, 1),
            (cmap.OP_EMIT, 0, 0)]))
        rule_no = len(m.rules) - 1
    rule = m.rules[rule_no]
    fn = mapper.compile_rule(m.flatten(), rule.steps, args.num_rep,
                             device=device)
    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.int32)
    dev_w = np.full(m.max_devices, 0x10000, dtype=np.uint32)
    if args.weight:
        for osd, w in args.weight:
            dev_w[osd] = int(float(w) * 0x10000)
    out = fn(xs, dev_w).cpu().numpy()

    valid = (out != ITEM_NONE) & (out >= 0)
    sizes = valid.sum(axis=1)
    stats = {
        "rule": rule_no,
        "num_rep": args.num_rep,
        "x_range": [args.min_x, args.max_x],
        "total_mappings": int(len(xs)),
        "bad_mappings": int((sizes < args.num_rep).sum()),
    }
    result = {"statistics": stats}
    if args.show_utilization or args.show_statistics:
        flat = out[valid]
        counts = np.bincount(flat, minlength=m.max_devices)
        expected = counts.sum() / max((dev_w > 0).sum(), 1)
        stats["device_utilization"] = {
            "min": int(counts.min()), "max": int(counts.max()),
            "mean": round(float(counts.mean()), 2),
            "stddev": round(float(counts.std()), 2),
            "expected_per_device": round(float(expected), 2),
        }
        if args.show_utilization:
            result["utilization"] = {
                f"osd.{i}": int(c) for i, c in enumerate(counts)}
    if args.show_mappings:
        result["mappings"] = {
            int(x): [int(o) for o in row if o != ITEM_NONE]
            for x, row in zip(xs[:args.max_show], out[:args.max_show])}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool")
    p.add_argument("-i", "--infn", help="input map file")
    p.add_argument("-o", "--outfn", help="output map file")
    p.add_argument("-d", "--decompile", action="store_true",
                   help="decompile -i map to text (CrushCompiler role)")
    p.add_argument("-c", "--compile", dest="compilefn", metavar="TEXTFN",
                   help="compile a text map (write binary with -o)")
    p.add_argument("--build", action="store_true")
    p.add_argument("--num_osds", type=int, default=0)
    p.add_argument("layers", nargs="*",
                   help="--build layers: name alg size triples")
    p.add_argument("--test", action="store_true")
    p.add_argument("--rule", type=int, default=0)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--max-show", type=int, default=32)
    p.add_argument("--weight", nargs=2, action="append", default=[],
                   type=str, metavar=("OSD", "W"))
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain version)")
    args = p.parse_args(argv)
    args.weight = [(int(o), w) for o, w in args.weight]

    if args.build:
        if args.num_osds <= 0 or len(args.layers) % 3:
            print("--build needs --num_osds and name alg size triples",
                  file=sys.stderr)
            return 1
        layers = [(args.layers[i], args.layers[i + 1],
                   int(args.layers[i + 2]))
                  for i in range(0, len(args.layers), 3)]
        m = build_map(args.num_osds, layers)
    elif args.compilefn:
        from ceph_tpu_torch.crush.compiler import compile_text

        with open(args.compilefn) as f:
            m = compile_text(f.read())
    elif args.infn:
        with open(args.infn, "rb") as f:
            m = decode_crush(Decoder(f.read()))
    else:
        print("need --build, -c or -i", file=sys.stderr)
        return 1

    if args.decompile:
        from ceph_tpu_torch.crush.compiler import decompile

        text = decompile(m)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return 0

    if args.outfn:
        e = Encoder()
        encode_crush(e, m)
        with open(args.outfn, "wb") as f:
            f.write(e.bytes())
        print(f"wrote crush map to {args.outfn}")
    if args.test:
        print(json.dumps(run_test(m, args, args.device), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
