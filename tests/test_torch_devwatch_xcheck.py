"""The port's device watch and shape-bucket grammar held to the
reference's (``ceph_tpu/tpu/devwatch.py``, ``ceph_tpu/tpu/shapebucket.py``):

- one ``compile_begin``/``compile_end``/``note_hit`` sequence, warmup
  scope and storm conf included, under one patched clock, gives equal
  ``dump()`` families, totals and storms, the same ``RECOMPILE_STORM``
  text up to its closing advice (the reference's names a change of its
  own history; both name ``shapebucket.covering``), and byte-equal
  ``export_prometheus`` lines in both packages;
- the same shapes as numpy arrays (the reference's signature) and as
  torch tensors (the port's) give equal ``signature``, ``sig_str`` and
  ``_churn_dim``;
- ``BucketSpec.sig_declared`` answers alike over a seeded list of
  signatures.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.tpu import devwatch as ref_dw
from ceph_tpu.tpu import shapebucket as ref_sb
from ceph_tpu_torch.gpu import devwatch as dw
from ceph_tpu_torch.gpu import shapebucket as sb

SEED = 2028


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class _Log:
    def __init__(self) -> None:
        self.cluster_msgs = []

    def log(self, subsys, level, msg):
        pass

    def cluster(self, level, msg):
        self.cluster_msgs.append((level, msg))


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr("time.monotonic", c)
    monkeypatch.setattr("time.time", lambda: 1760000000.5)
    yield c


@pytest.fixture
def registries():
    """The same test families declared in both registries."""
    saved = dict(ref_sb._REGISTRY), dict(sb._REGISTRY)
    for mod in (ref_sb, sb):
        mod.declare("t_x")
        mod.declare("t_free", free_args=(1,), small_max=8)
    yield
    for mod, old in zip((ref_sb, sb), saved):
        mod._REGISTRY.clear()
        mod._REGISTRY.update(old)


def _shapes(rng, n):
    """Seeded shapes: ladder rungs, static geometry and odd widths."""
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 13))
        w = int(rng.choice([int(rng.integers(1, 5000)),
                            1 << int(rng.integers(6, 20)),
                            3 << int(rng.integers(6, 16))]))
        out.append((k, w))
    return out


def _sig(mod, k, w, torch_args):
    if torch_args:
        a = torch.zeros((k, w), dtype=torch.uint8)
        b = torch.zeros(7 * k + 1, dtype=torch.int32)
    else:
        a = np.zeros((k, w), np.uint8)
        b = np.zeros(7 * k + 1, np.int32)
    return mod.signature((a, b, 3), {})


def _drive(mod, clock, torch_args):
    """One scripted run of a fresh watch of ``mod``; returns it and the
    cluster messages its storms raised."""
    w = mod.DeviceWatch()
    log = _Log()
    w.attach_log(log)
    w.configure(window_s=30.0, min_sigs=3, min_rogue_sigs=3)
    rng = np.random.default_rng(SEED)
    for i, (k, width) in enumerate(_shapes(rng, 24)):
        fam = ("t_x", "t_free", "t_undeclared")[i % 3]
        if fam == "t_x":  # a declared ladder rung
            width = 1 << max(6, (width - 1).bit_length())
        sig = _sig(mod, k, width, torch_args)
        if i % 5 == 0:
            with w.warmup_scope():
                tok = w.compile_begin(fam)
                clock.t += 0.125 * (1 + i % 4)
                w.compile_end(tok, sig)
        else:
            tok = w.compile_begin(fam)
            clock.t += 0.25 * (1 + i % 3)
            w.compile_end(tok, sig, error=(i == 7))
        for j in range(i % 4):
            w.note_hit(fam, 1e-6 * (3 + 17 * j + i))
        clock.t += 1.5
    return w, log.cluster_msgs


def test_one_sequence_gives_the_same_table_storms_and_exposition(
        clock, registries):
    t0 = clock.t
    ref, ref_msgs = _drive(ref_dw, clock, torch_args=False)
    clock.t = t0
    port, port_msgs = _drive(dw, clock, torch_args=True)
    a, b = ref.dump(), port.dump()
    assert a["families"] == b["families"]
    assert a["totals"] == b["totals"]
    assert a["storms"] == b["storms"]
    assert b["storms"], "the sequence raised no storm to compare"
    assert {s["kind"] for s in b["storms"]} == {"rogue", "declared"}
    advice = "(shapebucket.covering"
    assert [(lvl, m.split(advice)[0]) for lvl, m in ref_msgs] == \
        [(lvl, m.split(advice)[0]) for lvl, m in port_msgs]
    assert all("RECOMPILE_STORM" in m and advice in m
               for _l, m in ref_msgs + port_msgs)
    assert ref.compile_totals() == port.compile_totals()
    for fam in ("t_x", "t_free", "t_undeclared", "nope"):
        assert ref.family_stats(fam) == port.family_stats(fam)
    lines_a, lines_b = [], []
    ref.export_prometheus(lines_a)
    port.export_prometheus(lines_b)
    assert "\n".join(lines_a).encode() == "\n".join(lines_b).encode()
    assert any(ln.startswith('ceph_xla_exec_us_bucket{family="t_x",'
                             'le="+Inf"}') for ln in lines_b)


def test_signatures_of_arrays_and_tensors_agree():
    rng = np.random.default_rng(SEED)
    ref_sigs, port_sigs = [], []
    for k, w in _shapes(rng, 40):
        ra = ref_dw.signature((np.zeros((k, w), np.uint8), 5, None, "s",
                               b"xy"), {"n": np.zeros(k, np.int64)},
                              static_argnums=(1,))
        pa = dw.signature((torch.zeros((k, w), dtype=torch.uint8), 5, None,
                           "s", b"xy"),
                          {"n": torch.zeros(k, dtype=torch.int64)},
                          static_argnums=(1,))
        assert ra == pa
        assert ref_dw.sig_str(ra) == dw.sig_str(pa)
        ref_sigs.append(ref_dw.signature((np.zeros((k, w), np.uint8),), {}))
        port_sigs.append(dw.signature(
            (torch.zeros((k, w), dtype=torch.uint8),), {}))
    for n in (2, 3, 7, 40):
        assert ref_dw._churn_dim(ref_sigs[:n]) == dw._churn_dim(
            port_sigs[:n])
    mixed = [dw.signature((torch.zeros(4, dtype=torch.uint8), k), {},
                          static_argnums=(1,)) for k in (1, 2, 3)]
    assert dw._churn_dim(mixed) == ref_dw._churn_dim(
        [ref_dw.signature((np.zeros(4, np.uint8), k), {},
                          static_argnums=(1,)) for k in (1, 2, 3)])


@pytest.mark.parametrize("kw", [{}, {"small_max": 8, "odd_max": 3},
                                {"free_args": (1,), "ceiling": 1 << 14}])
def test_sig_declared_answers_alike(kw):
    mine, ref = sb.BucketSpec("x", **kw), ref_sb.BucketSpec("x", **kw)
    rng = np.random.default_rng(SEED)
    answers = []
    for k, w in _shapes(rng, 200):
        sig = dw.signature((torch.zeros((k, w), dtype=torch.uint8),
                            torch.zeros(int(rng.integers(1, 3000)),
                                        dtype=torch.int32)), {})
        assert mine.sig_declared(sig) == ref.sig_declared(sig), sig
        answers.append(mine.sig_declared(sig))
    assert any(answers) and not all(answers)
