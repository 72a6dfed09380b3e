"""OpTracker — in-flight op tracking with slow-op and historic dumps.

Reference role: src/common/TrackedOp.h + src/osd/OpRequest.h (the
`ceph daemon <osd> dump_ops_in_flight / dump_historic_ops /
dump_historic_slow_ops` surface): every tracked op records its arrival
and a timeline of state events; completed ops feed a bounded history,
slow ones (>= threshold) a separate ring so stalls leave evidence.

Stage attribution: timeline events use names declared in
``tracing.STAGES``, and each stage whose registry entry names a
histogram ALSO feeds that log2 latency histogram (the daemon's
``osd.N.op`` set) with the microseconds since the PREVIOUS event — so
per-stage p50/p99 is derivable from ``perf dump`` with tracing off.

Lifecycle contract: every tracked op ends with a TERMINAL stage
(``commit_sent`` / ``read_sent`` / ``eagain`` / ``aborted`` /
``daemon_shutdown``) and
lands in history — ops that EAGAIN at the peering gate or are answered
by the write-deadline sweep included.  An op whose terminal stage was
recorded but that never left the in-flight table is a lifecycle LEAK:
``drain()`` (daemon teardown) reports it on the ``LEAKS`` channel,
which a test harness can assert empty after every test (the
loop-stall sanitizer shape).

Port of ``ceph_tpu/core/optracker.py``, name for name.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.tracing import STAGES

# marking one of these concludes the op: unregister skips the implicit
# "done", and a daemon draining a CONCLUDED-but-still-in-flight op
# records a lifecycle leak (its reply went out; nothing can finish it)
TERMINAL_STAGES = frozenset((
    "done", "commit_sent", "read_sent", "eagain", "aborted",
    "daemon_shutdown", "leaked",
))

# lifecycle-leak evidence (a sanitizer channel, the LOOP_STALLS
# shape): ops whose terminal stage was recorded but that never left
# the in-flight table
LEAKS: List[str] = []

# histograms fed directly by instrumented sites rather than through
# the mark_event flow (declared alongside the stage hists so one
# declare_op_hists() builds the whole osd.N.op set)
EXTRA_HISTS: Dict[str, str] = {
    "lat_fanout_rtt_us": "per-peer sub-write send -> commit ack",
    "lat_recovery_round_us": "one windowed recovery round, send -> settled",
    "lat_parked_read_us": "recover-on-read park -> wake",
    "lat_op_us": "tracked op total: receive -> terminal event",
    "lat_compile_wait_us": "op encode wait overlapped by a live "
                           "compile (devwatch blame)",
}


def declare_op_hists(pc) -> None:
    """Build a daemon's ``osd.N.op`` per-stage histogram set (adds are
    idempotent, like every PerfCounters builder)."""
    for stage, hist in STAGES.items():
        if hist:
            pc.add_histogram(hist, f"stage latency ending at {stage!r} (us)")
    for name, desc in EXTRA_HISTS.items():
        pc.add_histogram(name, desc)


class TrackedOp:
    __slots__ = ("tracker", "desc", "start", "events", "done_at",
                 "trace_ctx", "_last", "concluded", "_mu")

    def __init__(self, tracker: "OpTracker", desc: str,
                 start: Optional[float] = None) -> None:
        self.tracker = tracker
        self.desc = desc
        # start may be the messenger's receive stamp: the first stage
        # delta then covers frame decode + dispatch, not just tracking
        self.start = time.monotonic() if start is None else start
        self.events: List = [(0.0, "initiated", "")]
        self._last = self.start
        self.done_at: Optional[float] = None
        self.concluded = False
        self.trace_ctx = None  # (trace_id, span_id) when the op is traced
        # stages are marked from different threads (submitted on the
        # fan-out lane, commit/ack_gated on store-commit callbacks, the
        # deadline sweep on the osd tick): the per-op lock keeps the
        # timeline ordered and the since-previous-event histogram
        # deltas non-negative, and makes conclusion (terminal event +
        # done_at) atomic against straggler marks
        self._mu = make_lock("optracker.op")

    def mark_event(self, stage: str, detail: str = "",
                   annotation: bool = False) -> "TrackedOp":
        """annotation=True records the event on the timeline WITHOUT
        advancing the since-previous-event baseline: out-of-band
        observations (e.g. compile_wait blame from the device worker)
        must not shift the adjacent pipeline stages' histogram
        deltas."""
        with self._mu:
            return self._mark_locked(stage, detail,
                                     annotation=annotation)

    def _mark_locked(self, stage: str, detail: str = "",
                     annotation: bool = False) -> "TrackedOp":
        if self.done_at is not None:
            # the op already concluded into history (e.g. the deadline
            # sweep answered EAGAIN): a straggler commit firing later
            # must not mutate the dumped timeline or feed a bogus
            # since-the-reply delta into the stage histograms
            return self
        now = time.monotonic()
        self.events.append((now - self.start, stage, detail))
        if annotation:
            return self
        hist = STAGES.get(stage, "")
        perf = self.tracker.perf
        if hist and perf is not None:
            perf.hinc(hist, (now - self._last) * 1e6)
        self._last = now
        if stage in TERMINAL_STAGES:
            self.concluded = True
        return self

    @property
    def age(self) -> float:
        end = self.done_at if self.done_at is not None else time.monotonic()
        return end - self.start

    def finish(self, stage: Optional[str] = None, detail: str = "") -> None:
        self.tracker.unregister(self, stage=stage, detail=detail)

    def dump(self) -> Dict[str, Any]:
        with self._mu:  # in-flight dumps race live marks
            events = list(self.events)
        out = {
            "description": self.desc,
            "age": round(self.age, 6),
            "events": [{"t": round(t, 6),
                        "event": f"{s} {d}" if d else s}
                       for t, s, d in events],
        }
        if self.trace_ctx is not None:
            out["trace_id"] = f"{self.trace_ctx[0]:016x}"
        return out

    # context-manager sugar (finish() is idempotent, so an explicit
    # finish inside the block is fine)
    def __enter__(self) -> "TrackedOp":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and not self.concluded:
            self.finish(stage="aborted", detail=repr(exc))
        else:
            self.finish()


class OpTracker:
    def __init__(self, slow_op_threshold: float = 1.0,
                 history_size: int = 20, slow_history_size: int = 20,
                 perf=None):
        self.slow_op_threshold = slow_op_threshold
        # optional per-stage histogram sink (the daemon's osd.N.op
        # PerfCounters, pre-declared via declare_op_hists)
        self.perf = perf
        self._lock = threading.Lock()
        self._in_flight: Dict[int, TrackedOp] = {}
        self._history = collections.deque(maxlen=history_size)
        self._slow = collections.deque(maxlen=slow_history_size)
        self.ops_tracked = 0
        self.slow_ops = 0
        self.ops_leaked = 0

    def create_op(self, desc: str,
                  start: Optional[float] = None) -> TrackedOp:
        op = TrackedOp(self, desc, start=start)
        with self._lock:
            self._in_flight[id(op)] = op
            self.ops_tracked += 1
        return op

    def unregister(self, op: TrackedOp, stage: Optional[str] = None,
                   detail: str = "") -> None:
        with self._lock:
            if self._in_flight.pop(id(op), None) is None:
                return  # idempotent: second finish (context-manager
                # sugar after an explicit finish, racing reply paths)
        with op._mu:
            # terminal event + done_at land atomically: a straggler
            # mark either precedes the terminal event in the timeline
            # or sees done_at and drops
            if stage is None and not op.concluded:
                stage = "done"
            if stage:
                op._mark_locked(stage, detail)
            op.done_at = time.monotonic()
        if self.perf is not None:
            self.perf.hinc("lat_op_us", (op.done_at - op.start) * 1e6)
        with self._lock:
            self._history.append(op)
            if op.age >= self.slow_op_threshold:
                self._slow.append(op)
                self.slow_ops += 1

    def drain(self, reason: str = "daemon_shutdown") -> None:
        """Daemon teardown: every in-flight op moves to history.  An op
        that CONCLUDED (terminal stage recorded — its reply went out)
        but never unregistered is a lifecycle leak and is reported on
        the LEAKS sanitizer channel; ops genuinely cut down mid-flight
        (a thrash kill landing between submit and commit) are not."""
        with self._lock:
            ops = list(self._in_flight.values())
        for op in ops:
            if op.concluded:
                self.ops_leaked += 1
                LEAKS.append(
                    f"{op.desc}: terminal event "
                    f"{op.events[-1][1]!r} recorded but the op never "
                    f"left the in-flight table")
                self.unregister(op, stage="leaked")
            else:
                self.unregister(op, stage=reason)

    @property
    def num_in_flight(self) -> int:
        with self._lock:
            return len(self._in_flight)

    def slow_depth(self, window_s: float = 30.0) -> int:
        """Live slow-op pressure for the mon's SLOW_OPS health check:
        in-flight ops already past the complaint threshold, plus slow
        ring entries whose completion is younger than ``window_s`` —
        so the check fires while a stall is fresh and CLEARS once the
        ring evidence ages out (the entries stay dumpable; only the
        health signal decays)."""
        now = time.monotonic()
        with self._lock:
            live = sum(1 for op in self._in_flight.values()
                       if op.age >= self.slow_op_threshold)
            recent = sum(1 for op in self._slow
                         if op.done_at is not None
                         and now - op.done_at < window_s)
        return live + recent

    # -- dumps (admin socket payloads) --------------------------------
    def dump_in_flight(self) -> Dict[str, Any]:
        with self._lock:
            ops = sorted(self._in_flight.values(), key=lambda o: o.start)
            return {"num_ops": len(ops),
                    "ops": [o.dump() for o in ops]}

    def dump_historic(self) -> Dict[str, Any]:
        with self._lock:
            return {"num_ops": len(self._history),
                    "ops": [o.dump() for o in self._history]}

    def dump_slow(self) -> Dict[str, Any]:
        with self._lock:
            return {"threshold": self.slow_op_threshold,
                    "num_ops": len(self._slow),
                    "ops": [o.dump() for o in self._slow]}
