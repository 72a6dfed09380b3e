"""Distributed trace spans (the blkin/Zipkin + LTTng tracepoint role).

Reference: src/blkin/ (Zipkin-style trace/span/parent ids propagated
with requests, annotations at interesting points) and the LTTng-UST
tracepoints compiled into the daemons (src/tracing/*.tp).  Here:

- `Tracer.start_span(name, parent=...)` opens a span; `span.annotate()`
  adds timestamped events; `span.finish()` archives it in a bounded
  ring.
- Wire propagation is by VALUE, not by magic: `span.context()` returns
  (trace_id, span_id) to embed in a message (the client library puts it
  in the op reqid; any carrier works), and the receiving daemon opens
  its span with `parent=that_context` — the cross-daemon parent/child
  chain of blkin.
- `Tracer.dump(trace_id)` returns the archived spans of one trace,
  `Tracer.recent()` the ring tail — the admin-socket surface.

Tracepoint analog: `Tracer.event(subsys, name, **kw)` records a flat
timestamped event in the same ring when tracing is enabled — the
compiled-in, off-by-default tracepoint shape.

Port of ``ceph_tpu/core/tracing.py``: the same stage table and the same
:func:`trace_id_of`, which hashes through the port's host CRC-32C
(``core/crc.py``), so both packages derive one trace id per request.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

TraceContext = Tuple[int, int]  # (trace_id, span_id)

# -- stage-name registry -----------------------------------------------------
#
# Every stage event recorded on an op timeline (TrackedOp.mark_event)
# or annotated as a literal stage on a hot-path span must come from
# this table.  The name IS the contract between the instrumented site,
# the per-stage latency histogram it feeds (the osd.N.op `lat_*_us`
# counters — value below; '' = timeline-only), and every dump consumer
# (dump_historic_slow_ops, the mgr merge, cephtop, thrash forensics).
# A typo'd site is a dead timeline row that silently never feeds its
# histogram (the reference's cephlint `span-discipline` check holds
# literal call-site names to this table).
#
# Primary write-pipeline order (each histogram buckets the latency
# since the PREVIOUS timeline event, in microseconds):
#   initiated -> queued_for_pg -> qos_admitted -> reached_pg ->
#   [staged] -> admitted -> submitted -> commit -> [ack_gated]
#   -> commit_sent
STAGES: Dict[str, str] = {
    # client / generic
    "sent": "",                # client: op handed to the messenger
    "initiated": "",           # tracker entry created (messenger receive)
    # daemon dispatch
    "queued_for_pg": "lat_recv_us",      # decode -> sharded-queue entry
    # QoS admission: the dmClock (or fifo A/B) scheduler
    # granted this op a workqueue slot — the delta since
    # queued_for_pg is the scheduler wait, the per-tenant fairness
    # number; reached_pg then measures only the dispatch residual
    "qos_admitted": "lat_qos_wait_us",
    "reached_pg": "lat_queue_us",        # queue wait: a shard picked it up
    # write pipeline
    "staged": "lat_staging_us",          # pinned staging-pool acquire
    "admitted": "lat_admission_us",      # _OidPipe admission FIFO grant
    "submitted": "lat_encode_fanout_us",  # exec+encode queued+fan-out sent
    "commit": "lat_commit_wait_us",      # last shard ack arrived
    "ack_gated": "lat_ack_gate_us",      # durable-ack gate released
    "commit_sent": "lat_reply_us",       # reply sent to the client
    # device runtime: annotation, not a pipeline stage — the
    # overlap duration feeds lat_compile_wait_us DIRECTLY (an
    # EXTRA_HISTS entry), because the blame is "how long a live
    # compile overlapped this op's encode wait", not a
    # since-previous-event delta (the port builds its kernels once, so
    # nothing in it marks this stage yet; the name stays for parity)
    "compile_wait": "",        # encode batch stalled behind a live compile
    # read path
    "parked": "",              # read parked on recover-on-read
    "read_sent": "lat_read_us",  # terminal for reads: execute -> reply
    #   (reads must NOT conclude as commit_sent — that would feed the
    #   whole read service time into lat_reply_us, which for writes
    #   measures only reply-send time)
    # peer-side span stages (cross-daemon children)
    "sub_write_recv": "",      # peer: MECSubWriteVec dispatched
    "store_commit": "",        # peer: merged store transaction durable
    "sub_read_served": "",     # peer: MECSubReadVec rows answered
    "note_persisted": "",      # peer: commit-note watermark on stable storage
    # terminal events (history admission; see optracker.TERMINAL_STAGES)
    "done": "",
    "eagain": "",              # retryable reply (peering gate, deadline sweep)
    "aborted": "",             # error reply or dispatch exception
    "daemon_shutdown": "",     # daemon went down with the op in flight
    "leaked": "",              # force-finished lifecycle leak (a bug)
}


class Span:
    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "start", "end", "annotations")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: int) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.time()
        self.end = 0.0
        self.annotations: List[Tuple[float, str]] = []

    def annotate(self, what: str) -> None:
        self.annotations.append((time.time(), what))

    def context(self) -> TraceContext:
        """The wire-propagatable identity of this span."""
        return (self.trace_id, self.span_id)

    def finish(self) -> None:
        if not self.end:
            self.end = time.time()
            self.tracer._archive(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent_id": (f"{self.parent_id:016x}"
                          if self.parent_id else None),
            "start": self.start,
            "duration_s": round((self.end or time.time()) - self.start, 6),
            "annotations": [
                {"at": at, "what": w} for at, w in self.annotations],
        }


class Tracer:
    """Per-daemon span recorder; disabled tracers are near-free."""

    def __init__(self, name: str = "", enabled: bool = True,
                 ring_size: int = 2048) -> None:
        self.name = name
        self.enabled = enabled
        self._ring: Deque[Span] = collections.deque(maxlen=ring_size)
        self._lock = threading.Lock()

    # -- spans -------------------------------------------------------------
    def start_span(self, name: str,
                   parent: Optional[TraceContext] = None) -> Span:
        if parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = random.getrandbits(63) | 1, 0
        return Span(self, name, trace_id, random.getrandbits(63) | 1,
                    parent_id)

    def _archive(self, span: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(span)

    # -- tracepoints -------------------------------------------------------
    def event(self, subsys: str, name: str, **kw) -> None:
        """Flat tracepoint (the LTTng .tp role): recorded only when
        enabled, compiled in always."""
        if not self.enabled:
            return
        s = Span(self, f"{subsys}:{name}", 0, 0, 0)
        s.end = s.start
        if kw:
            s.annotations.append((s.start, repr(kw)))
        with self._lock:
            self._ring.append(s)

    # -- query (admin-socket surface) --------------------------------------
    def dump(self, trace_id: int) -> List[Dict]:
        with self._lock:
            spans = [s for s in self._ring if s.trace_id == trace_id]
        return [s.to_dict() for s in sorted(spans, key=lambda s: s.start)]

    def recent(self, n: int = 100) -> List[Dict]:
        with self._lock:
            tail = list(self._ring)[-n:]
        return [s.to_dict() for s in tail]


def trace_id_of(reqid: str) -> int:
    """Deterministic trace id from a request id: every daemon touching
    one client op derives the SAME trace id without any wire change —
    the reqid IS the correlator (the reference's osd_reqid_t threading
    through op tracking)."""
    from ceph_tpu_torch.core.crc import crc32c

    b = reqid.encode()
    return ((crc32c(b) << 32) | crc32c(b, 0xA5A5A5A5)) | 1


_global = Tracer("global")


def tracer() -> Tracer:
    return _global
