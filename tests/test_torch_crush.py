"""The port's CRUSH host modules held against ceph_tpu on the CPU, bit for
bit, mirroring tests/test_crush_hash.py and tests/test_crush_compiler.py
(the binary-codec case on the port's ``osd/map_codec.py``): rjenkins
hashes and crush_ln in numpy and torch, the straw2 draw, the map
constructors and their flattened arrays, a map carried across from the
reference's arrays (``flatmap_from_arrays``), the text compiler, the
binary map codec, and ``crushtool`` against the reference tool."""

import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu import _native
from ceph_tpu.crush import compiler as ref_compiler
from ceph_tpu.crush import hashes as ref_hashes
from ceph_tpu.crush import ln as ref_ln
from ceph_tpu.crush import map as ref_map
from ceph_tpu_torch.crush import hashes, ln, mapper, samples
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.crush.compiler import (CompileError, compile_text,
                                           decompile)
from ceph_tpu_torch.tools import crushtool

REPO = Path(__file__).resolve().parent.parent
FLAT_FIELDS = ("items", "weights", "sizes", "algs", "types", "straws",
               "sum_weights", "tree_weights", "tree_nodes")


def _u32(seed, n, k):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
            for _ in range(k)]


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


# -- hashes (tests/test_crush_hash.py) ---------------------------------------

def test_hash3_matches_native():
    a, b, c = _u32(0, 512, 3)
    want = np.array([_native.hash3(int(x), int(y), int(z))
                     for x, y, z in zip(a, b, c)], dtype=np.uint32)
    np.testing.assert_array_equal(hashes.hash32_3(a, b, c), want)
    np.testing.assert_array_equal(
        hashes.hash32_3(_t(a), _t(b), _t(c), xp=torch).numpy(), want)


def test_hash2_matches_native():
    a, b = _u32(1, 512, 2)
    want = np.array([_native.hash2(int(x), int(y)) for x, y in zip(a, b)],
                    dtype=np.uint32)
    np.testing.assert_array_equal(hashes.hash32_2(a, b), want)
    np.testing.assert_array_equal(
        hashes.hash32_2(_t(a), _t(b), xp=torch).numpy(), want)


@pytest.mark.parametrize("arity", [1, 2, 3, 4, 5])
def test_torch_hash_matches_numpy_and_reference(arity):
    args = _u32(2 + arity, 256, arity)
    name = "hash32" if arity == 1 else f"hash32_{arity}"
    want = getattr(ref_hashes, name)(*args)
    np.testing.assert_array_equal(getattr(hashes, name)(*args), want)
    # int32 words (negative bucket ids) and int64 values hash alike
    for conv in (_t, lambda a: torch.from_numpy(a.view(np.int32))):
        got = getattr(hashes, name)(*[conv(a) for a in args], xp=torch)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_crush_ln_exact_all_16bit():
    u = np.arange(0x10000, dtype=np.uint32)
    want = np.array([_native.crush_ln(int(x)) for x in u], dtype=np.int64)
    np.testing.assert_array_equal(ln.crush_ln(u), want)
    np.testing.assert_array_equal(ln.crush_ln(_t(u), xp=torch).numpy(), want)
    np.testing.assert_array_equal(ln.ln16_table(), ref_ln.ln16_table())


def test_straw2_draw_matches_scalar_formula():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 0x10000, size=1000).astype(np.uint32)
    w = rng.integers(1, 2 ** 20, size=1000).astype(np.uint32)
    w[::97] = 0
    draws = ln.straw2_draw(h, w)
    np.testing.assert_array_equal(draws, ref_ln.straw2_draw(h, w))
    np.testing.assert_array_equal(
        ln.straw2_draw(_t(h), _t(w), xp=torch).numpy(), draws)
    for i in range(1, 1000, 97):
        lnv = _native.crush_ln(int(h[i])) - 0x1000000000000
        assert draws[i] == -((-lnv) // int(w[i]))
    assert ln.straw2_draw(np.uint32(5), np.uint32(0)) == -(2 ** 63)
    num = np.array([-7, -8, 7, 0], dtype=np.int64)
    den = np.array([2, 3, 2, 5], dtype=np.int64)
    np.testing.assert_array_equal(ln.div64_trunc(num, den), [-3, -2, 3, 0])
    np.testing.assert_array_equal(
        ln.div64_trunc(torch.from_numpy(num), torch.from_numpy(den),
                       xp=torch).numpy(), [-3, -2, 3, 0])


def test_str_hash_rjenkins_matches_native():
    names = [b"", b"x", b"foo", b"rbd_data.123.00000000000000ff",
             b"a-much-longer-object-name-exceeding-twelve-bytes",
             bytes(range(256))]
    for name in names:
        want = _native.lib().ceph_oracle_str_hash(name, len(name))
        assert hashes.str_hash_rjenkins(name) == want & 0xFFFFFFFF, name
        assert hashes.str_hash_rjenkins(name) == \
            ref_hashes.str_hash_rjenkins(name)


# -- map construction and the flattened image --------------------------------

def _assert_flat_equal(port_flat, ref_flat):
    for f in FLAT_FIELDS:
        a, b = getattr(port_flat, f), getattr(ref_flat, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert port_flat.max_devices == ref_flat.max_devices
    assert dataclasses.asdict(port_flat.tunables) == \
        dataclasses.asdict(ref_flat.tunables)


def _mixed(mod):
    m = mod.CrushMap()
    hosts = []
    for h, alg in enumerate((1, 2, 3, 4, 5)):
        w = [0x10000] * 5 if alg == 1 else \
            [0x8000, 0x10000, 0x18000, 0, 0x20000]
        hosts.append(m.add_bucket(alg, 1, [h * 5 + i for i in range(5)], w))
    m.add_bucket(3, 10, hosts, [0x50000] * 5)
    m.reweight_item(hosts[4], 22, 0x30000)
    m.remove_item(hosts[1], 6)
    return m


@pytest.mark.parametrize("build", [
    lambda mod: mod.build_flat_cluster(32)[0],
    lambda mod: mod.build_flat_cluster(1024, hosts=64)[0],
    lambda mod: mod.build_flat_cluster(48, 0x8000, hosts=6, host_type=2)[0],
    _mixed])
def test_constructed_maps_flatten_to_the_reference_arrays(build):
    _assert_flat_equal(build(cmap).flatten(), build(ref_map).flatten())


def test_bucket_math_matches_reference():
    for ws in ([0x10000, 0x20000, 0x8000, 0x10000], [0, 0x10000, 0x10000],
               [0x30000] * 5, [7, 0, 123456, 0x10000, 99]):
        for v in (0, 1):
            assert cmap.calc_straws(ws, v) == ref_map.calc_straws(ws, v)
        assert cmap.calc_tree_weights(ws) == ref_map.calc_tree_weights(ws)
    for n in range(0, 40):
        assert cmap.calc_tree_depth(n) == ref_map.calc_tree_depth(n)
    straws = cmap.calc_straws([0x10000, 0x20000, 0x8000, 0x10000])
    assert straws[2] == 0x10000 and straws[1] > straws[0] >= straws[2]


def _carried(ref_flat):
    return cmap.flatmap_from_arrays(
        ref_flat.items, ref_flat.weights, ref_flat.sizes, ref_flat.algs,
        ref_flat.types, ref_flat.max_devices,
        dataclasses.asdict(ref_flat.tunables), straws=ref_flat.straws,
        sum_weights=ref_flat.sum_weights, tree_weights=ref_flat.tree_weights,
        tree_nodes=ref_flat.tree_nodes)


@pytest.mark.parametrize("name", ["chooseleaf_indep_6", "mixed_hosts_firstn",
                                  "tree_root_indep", "legacy_tunables_leaf"])
def test_flatmap_from_arrays_carries_the_reference_map(name):
    """The port's map made by its own constructors, and the same map made
    by the reference's and carried across as arrays, are one map:
    equal arrays and equal placements."""
    case = samples.case(name)
    port_flat = case.map.flatten()
    ref_m = ref_map.CrushMap(ref_map.Tunables(
        **dataclasses.asdict(case.map.tunables)))
    for bid in sorted(case.map.buckets, reverse=True):
        b = case.map.buckets[bid]
        ref_m.add_bucket(b.alg, b.type, b.items, b.weights, id=bid)
    carried = _carried(ref_m.flatten())
    _assert_flat_equal(carried, ref_m.flatten())
    _assert_flat_equal(port_flat, carried)
    xs = samples.ids(5, 128)
    a = mapper.compile_rule(port_flat, case.steps, case.result_max,
                            device="cpu")(xs, case.dev_weights)
    b = mapper.compile_rule(carried, case.steps, case.result_max,
                            device="cpu")(xs, case.dev_weights)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        cmap.flatmap_from_arrays(port_flat.items, port_flat.weights[:, :1],
                                 port_flat.sizes, port_flat.algs,
                                 port_flat.types, port_flat.max_devices,
                                 port_flat.tunables)


# -- the text compiler (tests/test_crush_compiler.py) ------------------------

TEXT = (REPO / "tests" / "test_crush_compiler.py").read_text().split(
    'TEXT = """', 1)[1].split('"""', 1)[0]


def test_compile_basic_structure():
    cm = compile_text(TEXT)
    assert set(cm.buckets) == {-1, -2, -3}
    assert cm.bucket_names == {-1: "host-a", -2: "host-b", -3: "default"}
    assert cm.buckets[-1].weights == [0x10000, 0x20000]
    assert cm.buckets[-3].items == [-1, -2]
    assert cm.type_names[10] == "root"
    assert cm.tunables.choose_total_tries == 50
    assert len(cm.rules) == 2
    assert cm.rules[0].steps == [
        (cmap.OP_TAKE, -3, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 0, 1),
        (cmap.OP_EMIT, 0, 0)]
    assert cm.rules[1].type == 3
    assert cm.rules[1].steps[0] == (cmap.OP_SET_CHOOSELEAF_TRIES, 5, 0)
    assert cm.choose_args["0"] == {-3: [0x10000, 0x40000]}
    ref = ref_compiler.compile_text(TEXT)
    assert decompile(cm) == ref_compiler.decompile(ref)
    _assert_flat_equal(cm.flatten(), ref.flatten())


def test_roundtrip_text_stable():
    cm = compile_text(TEXT)
    text2 = decompile(cm)
    cm2 = compile_text(text2)
    assert cm2.buckets.keys() == cm.buckets.keys()
    for bid in cm.buckets:
        assert cm2.buckets[bid].items == cm.buckets[bid].items
        assert cm2.buckets[bid].weights == cm.buckets[bid].weights
        assert cm2.buckets[bid].alg == cm.buckets[bid].alg
    assert [r.steps for r in cm2.rules] == [r.steps for r in cm.rules]
    assert cm2.choose_args == cm.choose_args
    assert cm2.bucket_names == cm.bucket_names
    assert decompile(cm2) == text2


def test_compiled_map_places_like_built_map():
    cm_text = compile_text(TEXT)
    cm_api = cmap.CrushMap(cm_text.tunables)
    cm_api.add_bucket(cmap.ALG_STRAW2, 1, [0, 1], [0x10000, 0x20000], id=-1)
    cm_api.add_bucket(cmap.ALG_STRAW2, 1, [2, 3], [0x10000, 0x10000], id=-2)
    cm_api.add_bucket(cmap.ALG_STRAW2, 10, [-1, -2], [0x30000, 0x20000],
                      id=-3)
    steps = [(cmap.OP_TAKE, -3, 0), (cmap.OP_CHOOSELEAF_FIRSTN, 0, 1),
             (cmap.OP_EMIT, 0, 0)]
    xs = np.arange(512, dtype=np.int32)
    dev_w = np.full(4, 0x10000, dtype=np.uint32)
    out_text = mapper.compile_rule(cm_text.flatten(), steps, 2,
                                   device="cpu")(xs, dev_w)
    out_api = mapper.compile_rule(cm_api.flatten(), steps, 2,
                                  device="cpu")(xs, dev_w)
    assert torch.equal(out_text, out_api)
    flat = cm_text.flatten()
    for x in range(0, 512, 37):
        want = _native.do_rule(flat, np.asarray(steps, np.int32).ravel(), x,
                               2, dev_w)
        got = out_text[x].numpy()
        assert list(got[:len(want)]) == list(want)


def test_compile_errors():
    for bad in ("host h { id -1 item osd.0 weight 1.0 ",
                "rule r { step frobnicate }",
                "host h {\nid -1\nitem nosuch weight 1.0\n}"):
        with pytest.raises(CompileError):
            compile_text(bad)
        with pytest.raises(ref_compiler.CompileError):
            ref_compiler.compile_text(bad)


def test_binary_codec_carries_names_and_choose_args():
    from ceph_tpu.core.encoding import Encoder as RefEncoder
    from ceph_tpu.osd.map_codec import encode_crush as ref_encode_crush
    from ceph_tpu_torch.core.encoding import Decoder, Encoder
    from ceph_tpu_torch.osd.map_codec import decode_crush, encode_crush

    cm = compile_text(TEXT)
    assert cm.choose_args and cm.bucket_names
    e = Encoder()
    encode_crush(e, cm)
    cm2 = decode_crush(Decoder(e.bytes()))
    assert cm2.bucket_names == cm.bucket_names
    assert cm2.choose_args == cm.choose_args
    assert decompile(cm2) == decompile(cm)
    re_ = RefEncoder()
    ref_encode_crush(re_, ref_compiler.compile_text(TEXT))
    assert e.bytes() == re_.bytes()


# -- crushtool ----------------------------------------------------------------

sys.path.insert(0, str(REPO / "tools"))
import crushtool as ref_crushtool  # noqa: E402


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("extra", [
    ["host", "straw2", "4", "root", "straw2", "0", "--num-rep", "3",
     "--show-statistics", "--show-utilization"],
    ["host", "straw2", "4", "root", "straw2", "0", "--num-rep", "2",
     "--show-utilization", "--show-mappings", "--weight", "3", "0"],
    ["host", "straw", "4", "root", "straw2", "0", "--num-rep", "3",
     "--show-statistics", "--weight", "5", "0.5"]])
def test_crushtool_test_equals_reference_tool(extra):
    argv = ["--build", "--num_osds", "16", "--test", "--min-x", "0",
            "--max-x", "255"] + extra
    rc, text = _capture(crushtool.main, argv + ["--device", "cpu"])
    rrc, rtext = _capture(ref_crushtool.main, argv)
    assert rc == rrc == 0
    assert json.loads(text) == json.loads(rtext)


def test_crushtool_text_maps_and_pending_binary(tmp_path):
    """Text maps, and the binary flags that once raised: ``-o`` writes the
    map codec's bytes (the reference tool's), ``-i`` reads them."""
    src = tmp_path / "map.txt"
    src.write_text(TEXT)
    out = tmp_path / "map2.txt"
    rc, _ = _capture(crushtool.main, ["-c", str(src), "-d", "-o", str(out)])
    assert rc == 0
    assert out.read_text() == decompile(compile_text(TEXT))
    rc, text = _capture(crushtool.main, ["-c", str(src), "--test",
                                         "--num-rep", "2", "--max-x", "99",
                                         "--show-statistics",
                                         "--device", "cpu"])
    assert rc == 0 and json.loads(text)["statistics"]["bad_mappings"] == 0
    port_bin, ref_bin = tmp_path / "p.bin", tmp_path / "r.bin"
    rc, _ = _capture(crushtool.main, ["-c", str(src), "-o", str(port_bin)])
    rrc, _ = _capture(ref_crushtool.main, ["-c", str(src), "-o", str(ref_bin)])
    assert rc == rrc == 0
    assert port_bin.read_bytes() == ref_bin.read_bytes()
    argv = ["-i", str(ref_bin), "--test", "--num-rep", "2", "--max-x", "99",
            "--show-mappings"]
    rc, text = _capture(crushtool.main, argv + ["--device", "cpu"])
    rrc, rtext = _capture(ref_crushtool.main, argv)
    assert rc == rrc == 0 and json.loads(text) == json.loads(rtext)
    rc, text = _capture(crushtool.main, ["-d", "-i", str(port_bin)])
    assert rc == 0 and text == decompile(compile_text(TEXT))
