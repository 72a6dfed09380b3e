"""The port's trace spans (``ceph_tpu_torch/core/tracing.py``), case for
case against the unit cases of ``tests/test_tracing.py``, and its trace
ids bit-equal to the reference's.

The wire trace tail runs over the port's messages, each traced message
also byte-equal to the reference's; the cross-daemon tree, the
recovery-round spans and the pg op spans run on the port's cluster,
``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")`` (six port
daemons, the reference's map, ``device="cpu"``),
through the port's client.
"""

import numpy as np
import pytest

import torch_daemon_harness as H
from ceph_tpu.core import tracing as ref_tracing
from ceph_tpu_torch.core.tracing import STAGES, Tracer, trace_id_of

EC_POOL, REP_POOL = H.EC_POOL, H.REP_POOL
LibClient = H.LibClient


def MiniCluster(overrides=None):
    return H.DaemonCluster("ceph_tpu_torch", overrides=overrides,
                           device="cpu")


def test_span_parentage_and_dump():
    tr = Tracer("t")
    root = tr.start_span("client.op")
    root.annotate("sent")
    child = tr.start_span("osd.op", parent=root.context())
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    child.finish()
    root.finish()
    spans = tr.dump(root.trace_id)
    assert [s["name"] for s in spans] == ["client.op", "osd.op"]
    assert spans[0]["parent_id"] is None
    assert spans[1]["parent_id"] == spans[0]["span_id"]
    assert spans[0]["annotations"][0]["what"] == "sent"


def test_disabled_tracer_archives_nothing():
    tr = Tracer("t", enabled=False)
    with tr.start_span("x") as s:
        s.annotate("y")
    tr.event("osd", "enqueue")
    assert tr.recent() == []


def test_trace_id_of_is_deterministic_correlator():
    assert trace_id_of("client.1:42") == trace_id_of("client.1:42")
    assert trace_id_of("client.1:42") != trace_id_of("client.1:43")
    assert trace_id_of("x") & 1  # never zero


def test_tracepoint_events_and_ring_bound():
    tr = Tracer("t", ring_size=16)
    for i in range(40):
        tr.event("osd", "tick", i=i)
    got = tr.recent(100)
    assert len(got) == 16  # bounded ring
    assert got[-1]["name"] == "osd:tick"


def test_stage_registry_sane():
    # the write pipeline's histogram-fed stages, in order
    for s in ("queued_for_pg", "reached_pg", "admitted", "submitted",
              "commit", "ack_gated", "commit_sent"):
        assert s in STAGES
    # peer-side span stages the cross-daemon tree uses
    for s in ("store_commit", "sub_read_served", "note_persisted"):
        assert s in STAGES and STAGES[s] == ""


# -- cross-checks against ceph_tpu ---------------------------------------------


def _reqids():
    rng = np.random.default_rng(7)
    ids = ["", "x", "client.1:42", "client.4123.0:981273", "é" * 300]
    for _ in range(40):
        n = int(rng.integers(1, 2000))
        ids.append("".join(chr(int(c)) for c in rng.integers(32, 127, n)))
    return ids


@pytest.mark.parametrize("chunk", range(5))
def test_trace_id_of_equals_the_reference(chunk):
    """Every daemon of either package derives the same trace id for a
    request: the port's host CRC under trace_id_of, bit for bit."""
    ids = _reqids()[chunk::5]
    assert [trace_id_of(r) for r in ids] == \
        [ref_tracing.trace_id_of(r) for r in ids]


def test_stage_table_equals_the_reference():
    assert STAGES == ref_tracing.STAGES
    assert list(STAGES) == list(ref_tracing.STAGES)


def test_wire_trace_context_roundtrip_and_byte_stability():
    """The optional trace tail: carried when set, absent (and
    byte-identical to the pre-PR encoding) when not."""
    from ceph_tpu.osd import messages as ref_om
    from ceph_tpu_torch.msg.message import Message
    from ceph_tpu_torch.osd import messages as om

    vec = om.MECSubWriteVec((1, 2), 3, "o", b"t", [])
    plain = vec.to_bytes()
    vec.set_trace((0x1234, 0x5678))
    traced = vec.to_bytes()
    assert traced != plain
    back = Message.from_bytes(traced)
    assert back.trace_ctx() == (0x1234, 0x5678)
    back.set_trace(None)  # None = keep as-is
    assert back.trace_ctx() == (0x1234, 0x5678)
    # untraced re-encode of an untraced blob is byte-stable
    again = Message.from_bytes(plain)
    assert again.trace_ctx() is None
    assert again.to_bytes() == plain
    # the reference's message, traced and not, is the same bytes
    ref = ref_om.MECSubWriteVec((1, 2), 3, "o", b"t", [])
    assert ref.to_bytes() == plain
    ref.set_trace((0x1234, 0x5678))
    assert ref.to_bytes() == traced


def test_cross_daemon_trace_tree_over_admin_socket(tmp_path):
    """Acceptance: one client EC write on a MiniCluster (3 acting
    OSDs) yields a dumpable cross-daemon causal tree — client root ->
    primary do_op (pipeline stage annotations) -> >=2 peer sub_write
    children with store_commit annotations — retrievable by trace_id
    via the admin socket."""
    import time as _time

    from ceph_tpu_torch.core.admin_socket import admin_command
    from ceph_tpu_torch.osd import types as t_

    sock = str(tmp_path / "admin.sock")
    c = MiniCluster(overrides={"admin_socket": sock})
    c.ctx.trace.enabled = True
    cl = LibClient(c)
    try:
        io = cl.rc.ioctx(EC_POOL)
        op = io.aio_operate(
            "traced_ec",
            [t_.OSDOp(t_.OP_WRITEFULL, data=b"t" * 8192)])
        rep = op.result(15.0)
        assert rep.result == 0
        assert op.span is not None
        trace_id = op.span.trace_id
        # peer sub_write spans finish on their store-commit threads:
        # they may trail the client reply by a beat
        deadline = _time.time() + 10.0
        spans = []
        while _time.time() < deadline:
            spans = admin_command(sock, "dump_trace",
                                  trace_id=f"{trace_id:x}")
            if sum(1 for s in spans if ".sub_write" in s["name"]) >= 2:
                break
            _time.sleep(0.1)
        by_name = {}
        for s in spans:
            by_name.setdefault(s["name"].split(".", 1)[-1], []).append(s)
        assert len(by_name.get("op", [])) == 1, spans  # client.op
        client = by_name["op"][0]
        do_ops = [s for s in spans if ".do_op" in s["name"]]
        assert len(do_ops) == 1, spans
        do_op = do_ops[0]
        # parentage: client -> do_op -> each peer's sub_write
        assert do_op["trace_id"] == client["trace_id"]
        assert do_op["parent_id"] == client["span_id"]
        subs = [s for s in spans if ".sub_write" in s["name"]]
        assert len(subs) >= 2, spans
        for s in subs:
            assert s["parent_id"] == do_op["span_id"]
            whats = [a["what"] for a in s["annotations"]]
            assert any(w == "store_commit" for w in whats), whats
        # the primary's pipeline stages annotate its span
        whats = [a["what"].split(" ")[0] for a in do_op["annotations"]]
        for stage in ("admitted", "submitted", "commit"):
            assert stage in whats, do_op["annotations"]
    finally:
        cl.shutdown()
        c.shutdown()


def test_recovery_round_spans_and_peer_children():
    """Recovery rounds open spans; peers serving the window's vec
    sub-reads hang children off them (sub_read_served)."""
    import time as _time

    c = MiniCluster()
    c.ctx.trace.enabled = True
    cl = LibClient(c)
    try:
        io = cl.rc.ioctx(EC_POOL)
        io.write_full("rec_traced", b"r" * 16384)
        pgid, acting, primary = c.primary_of(EC_POOL, "rec_traced")
        # kill the PRIMARY: on revive it re-takes the pg and pulls its
        # missing shards through the windowed engine (the bench shape)
        c.kill(primary)
        io.write_full("rec_traced", b"R" * 16384)  # degraded write
        c.revive(primary)
        deadline = _time.time() + 15.0
        rounds, serves = [], []
        while _time.time() < deadline:
            recent = c.ctx.trace.recent(500)
            rounds = [s for s in recent
                      if s["name"].endswith("recovery.round")]
            serves = [s for s in recent if ".sub_read" in s["name"]]
            if rounds and serves:
                break
            _time.sleep(0.2)
        assert rounds, "no recovery-round span archived"
        round_ids = {s["span_id"] for s in rounds}
        assert any(s["parent_id"] in round_ids for s in serves), (
            rounds, serves)
    finally:
        cl.shutdown()
        c.shutdown()


def test_pg_op_spans_cross_daemon_correlation():
    """The PG op path emits spans correlated by reqid when tracing is
    on (covers the do_op wiring + admin dump shape)."""
    c = MiniCluster()
    c.ctx.trace.enabled = True
    cl = LibClient(c)
    try:
        io = cl.rc.ioctx(REP_POOL)
        io.write_full("traced", b"x")
        io.read("traced")
        spans = c.ctx.trace.recent(50)
        names = [s["name"] for s in spans]
        assert any(".do_op" in n for n in names)
        # the write and its read correlate to DIFFERENT traces
        tids = {s["trace_id"] for s in spans if ".do_op" in s["name"]}
        assert len(tids) >= 2
    finally:
        cl.shutdown()
        c.shutdown()
