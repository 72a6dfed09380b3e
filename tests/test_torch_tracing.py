"""The port's trace spans (``ceph_tpu_torch/core/tracing.py``), case for
case against the unit cases of ``tests/test_tracing.py``, and its trace
ids bit-equal to the reference's.

Four reference cases wait: the wire trace tail needs msg (slice 1b) and
the osd messages (1e); the cross-daemon tree, the recovery-round spans
and the pg op spans need the MiniCluster (1j).
"""

import numpy as np
import pytest

from ceph_tpu.core import tracing as ref_tracing
from ceph_tpu_torch.core.tracing import STAGES, Tracer, trace_id_of


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
