"""The port's crushtool and osdmaptool on the CPU (``--device cpu``): the
crushtool and osdmaptool cases of tests/test_cli_tools.py, case for case,
binary map files included (reference: src/tools/crushtool.cc,
src/tools/osdmaptool.cc).  Their JSON against the reference tools is
held in tests/test_torch_crush.py and tests/test_torch_osdmap_xcheck.py,
and a binary map crosses between the two packages here."""

import contextlib
import io
import json
import os

from ceph_tpu.core.encoding import Decoder as RefDecoder
from ceph_tpu.crush.compiler import decompile as ref_decompile
from ceph_tpu.osd.map_codec import decode_crush as ref_decode_crush
from ceph_tpu_torch.tools import crushtool, osdmaptool

CPU = ["--device", "cpu"]


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_crushtool_build_and_test(tmp_path):
    mapfn = str(tmp_path / "map.bin")
    rc, _ = _capture(crushtool.main, ["--build", "--num_osds", "16",
                                      "host", "straw2", "4",
                                      "root", "straw2", "0",
                                      "-o", mapfn])
    assert rc == 0 and os.path.exists(mapfn)
    rc, text = _capture(crushtool.main,
                        ["-i", mapfn, "--test", "--num-rep", "3",
                         "--min-x", "0", "--max-x", "499",
                         "--show-statistics", "--show-utilization"] + CPU)
    assert rc == 0
    out = json.loads(text)
    st = out["statistics"]
    assert st["total_mappings"] == 500 and st["bad_mappings"] == 0
    u = st["device_utilization"]
    assert u["min"] > 0 and abs(u["mean"] - 500 * 3 / 16) < 1
    assert len(out["utilization"]) == 16


def test_crushtool_weights_zero_out_device(tmp_path):
    mapfn = str(tmp_path / "m.bin")
    _capture(crushtool.main, ["--build", "--num_osds", "8",
                              "root", "straw2", "0", "-o", mapfn])
    rc, text = _capture(crushtool.main,
                        ["-i", mapfn, "--test", "--num-rep", "2",
                         "--max-x", "299", "--show-utilization",
                         "--weight", "3", "0"] + CPU)
    assert rc == 0
    out = json.loads(text)
    assert out["utilization"]["osd.3"] == 0


def test_osdmaptool_createsimple_and_test_map_pgs(tmp_path):
    mapfn = str(tmp_path / "osdmap.bin")
    rc, _ = _capture(osdmaptool.main,
                     ["--createsimple", "16", "--pg_num", "64",
                      "-o", mapfn] + CPU)
    assert rc == 0 and os.path.exists(mapfn)
    rc, text = _capture(osdmaptool.main, [mapfn, "--test-map-pgs"] + CPU)
    assert rc == 0
    out = json.loads(text)
    assert out["pool_pgs_examined"] == 64
    assert sum(out["osd_pg_counts"].values()) == 64 * 3
    assert out["summary"]["max"] >= out["summary"]["min"] > 0


def test_osdmaptool_upmap(tmp_path):
    mapfn = str(tmp_path / "osdmap2.bin")
    _capture(osdmaptool.main, ["--createsimple", "24", "--pg_num", "128",
                               "-o", mapfn] + CPU)
    rc, text = _capture(osdmaptool.main,
                        [mapfn, "--upmap", "--upmap-max", "16",
                         "--upmap-deviation", "0.5"] + CPU)
    assert rc == 0
    out = json.loads(text)
    assert out["upmaps"], "no upmap entries emitted"
    sd = out["stddev"]["pool.1"]
    assert sd["after"] <= sd["before"]


def test_crushtool_compile_decompile_roundtrip(tmp_path):
    """crushtool -d / -c (reference CrushCompiler, crushtool.cc)."""
    binfn = str(tmp_path / "m.bin")
    textfn = str(tmp_path / "m.txt")
    bin2fn = str(tmp_path / "m2.bin")
    rc, _ = _capture(crushtool.main, ["--build", "--num_osds", "8",
                                      "host", "straw2", "4",
                                      "root", "straw2", "0", "-o", binfn])
    assert rc == 0
    rc, _ = _capture(crushtool.main, ["-d", "-i", binfn, "-o", textfn])
    assert rc == 0
    text = open(textfn).read()
    assert "alg straw2" in text and "item osd.0 weight" in text
    rc, _ = _capture(crushtool.main, ["-c", textfn, "-o", bin2fn])
    assert rc == 0
    rc, out2 = _capture(crushtool.main, ["-d", "-i", bin2fn])
    assert rc == 0
    assert out2 == text
    # the binary file is the reference codec's: it decodes there to the
    # same map
    with open(bin2fn, "rb") as f:
        assert ref_decompile(ref_decode_crush(RefDecoder(f.read()))) == text
