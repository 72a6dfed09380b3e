"""DeviceWatch — process-wide observability of the port's device runtime.

Port of ``ceph_tpu/tpu/devwatch.py``, all of it: the per-family compile
table with the shape-bucket classification (warmup, bucketed-cold,
rogue), the recompile-storm detector, the steady-state guard
(:data:`GUARD_VIOLATIONS`), the compile blame the stripe-batch queue
asks for, the flight recorder, the ``osd.N.xla`` counter set, the
``device compile dump`` payload and the ``ceph_xla_*`` Prometheus
export.  Beside the reference's keys the dump keeps what only the port
has: the kernel build, launches per kernel (every ``_build.LaunchCount``)
and the queue's batches.

**What a compile is on the card.**  The port compiles no XLA program.
Its kernels are hand-written CUDA, built once and launched at any shape.
Two kinds of event stand where the reference's compiles stand, and
nothing else:

1. *The kernel build*, family :data:`BUILD_FAMILY`: the one ``nvcc``
   build of ``ops/_build.py`` (``_build.lib()``), recorded with its real
   wall and its [start, end] stamps.  It is the counterpart of the
   persistent compile cache too: a process that loaded a library already
   in ``ceph_tpu_torch/_build/`` without rebuilding it is
   :meth:`DeviceWatch.note_persist` ``(hit=True)``, one that built it
   ``hit=False`` (``_build`` tells them apart by the library file's
   modification time across the build).
2. *A first launch of a kernel at a signature this process has not
   launched*, the counterpart of XLA's trace re-entry.  On the card it
   pays for lazy module loading, the caching allocator's growth and the
   first execution.  :func:`instrumented_launch` times it as the
   reference's ``instrumented_jit`` times a compile (``:746-795``): the
   launch plus one synchronize of its stream, for that first launch
   only, and never while the stream is being captured into a CUDA
   graph.  A later launch at a seen signature is :meth:`note_hit`: its
   wall is the wrapper's dispatch wall on the card (no synchronize),
   which is the reference's own caveat (``:42-46``).

The families are the kernels, named as their launch counts are:
``gf256_matmul``, ``crc32c_rows``, ``crush_rule``, ``gf2_matmul``,
``gf2_xor``, ``gf256_interleaved`` and ``mesh_digest``.  Each wrapper
launches through :func:`instrumented_launch` on the card and on the CPU
alike (the CPU runs the plain version, so the CPU tests exercise the
table).  A signature is the arguments' shapes and dtypes only, read
without touching tensor data; a torch tensor's dtype renders as numpy
names it (``uint8``), so a tensor and an array of one shape give one
atom.  ``traces`` stays 0: nothing re-traces a kernel body in the port.
The warmup class comes from ``gpu/shapebucket.py``'s ``DeviceWarmup``,
which runs under :meth:`DeviceWatch.warmup_scope`.

The watch's lock is never held across a launch or a log call: log lines
are gathered under it and written after it is released, and the storm
WRN goes to the attached log's cluster channel outside it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.perf import PerfCounters
from ceph_tpu_torch.ops import _build

# steady-state guard evidence: first launches (and builds) observed
# inside a declared steady-state section.  The port's tests fail a test
# that leaves it non-empty (their own fixtures; the reference's
# conftest checks the reference's list)
GUARD_VIOLATIONS: List[str] = []

# the kernel build's family in the compile table
BUILD_FAMILY = "kernel_build"

# flight-recorder geometry
_EVENT_RING = 256        # compile + batch events kept for dumps
_SPAN_RING = 512         # finished compile spans kept for overlap math
_SIGS_KEPT = 32          # distinct signatures listed per family dump
_BATCH_RING = 256        # recent batches kept for dumps
_DUMP_BATCHES = 50       # listed by dump()
_STATE_BATCHES = 10      # listed by device_state()

# storm defaults (the reference's, ``tpu_recompile_storm_*``)
DEFAULT_STORM_WINDOW_S = 60.0
DEFAULT_STORM_MIN_SIGS = 8
DEFAULT_STORM_MIN_ROGUE_SIGS = 3


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype: ``torch.uint8`` renders ``uint8``."""
    s = str(dtype)
    return s[6:] if s.startswith("torch.") else s


def _sig_of(v: Any, static: bool = False) -> Tuple:
    """One argument's signature atom (the reference's ``:86``):
    shape/dtype for a tensor or array, the value for a declared-static
    argument, the type for a dynamic Python scalar."""
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        try:
            return ("arr", _dtype_name(dtype), tuple(int(d) for d in shape))
        except TypeError:  # symbolic dims: fall through to type name
            return ("arr", _dtype_name(dtype), str(shape))
    if static:
        return ("static", repr(v))
    if isinstance(v, (bool, int, float, complex)):
        return ("py", type(v).__name__)
    if v is None or isinstance(v, str):
        return ("val", repr(v))
    if isinstance(v, bytes):
        return ("val", f"bytes[{len(v)}]")
    return ("obj", type(v).__name__)


def signature(args: Tuple, kwargs: Dict[str, Any],
              static_argnums: Tuple[int, ...] = (),
              static_argnames: Tuple[str, ...] = ()) -> Tuple:
    """Shape/dtype signature of one call: the key :func:`instrumented_launch`
    keeps its seen set by."""
    sig = tuple(_sig_of(a, static=i in static_argnums)
                for i, a in enumerate(args))
    if kwargs:
        sig += tuple((k, _sig_of(v, static=k in static_argnames))
                     for k, v in sorted(kwargs.items()))
    return sig


_SCALAR_KINDS = ("val", "obj", "py", "static")


def sig_str(sig: Tuple) -> str:
    """Human rendering: ``uint8[2,4096], n=512``."""
    parts = []
    for atom in sig:
        if len(atom) == 3 and atom[0] == "arr":
            _k, dt, shape = atom
            dims = ",".join(str(d) for d in shape) \
                if isinstance(shape, tuple) else str(shape)
            parts.append(f"{dt}[{dims}]")
        elif len(atom) == 2 and atom[0] in _SCALAR_KINDS:
            parts.append(str(atom[1]))
        else:  # kwarg pair: (name, atom)
            parts.append(f"{atom[0]}={sig_str((atom[1],))}")
    return ", ".join(parts)


def _churn_dim(sigs: List[Tuple]) -> str:
    """The churning dimension across a storm's distinct signatures: the
    first argument position (and shape axis) whose values differ."""
    if not sigs:
        return "unknown"
    lens = {len(s) for s in sigs}
    if len(lens) != 1:
        return "arg-structure (argument count varies)"
    for i in range(len(sigs[0])):
        atoms = {s[i] for s in sigs}
        if len(atoms) <= 1:
            continue
        shapes = [a[2] for a in atoms
                  if len(a) == 3 and a[0] == "arr"
                  and isinstance(a[2], tuple)]
        if len(shapes) == len(atoms):
            ranks = {len(sh) for sh in shapes}
            if len(ranks) == 1:
                axes = [ax for ax in range(ranks.pop())
                        if len({sh[ax] for sh in shapes}) > 1]
                if axes:
                    return f"arg{i}.shape[{axes[0]}]" + (
                        f" (+{len(axes) - 1} more axes)"
                        if len(axes) > 1 else "")
            return f"arg{i}.shape (rank varies)"
        return f"arg{i}"
    return "unknown"


class _Family:
    __slots__ = ("sigs", "compiles", "compile_s", "hits", "dispatches",
                 "traces", "warmup", "cold", "rogue", "persist_hits",
                 "first_s")

    def __init__(self) -> None:
        self.sigs: "collections.OrderedDict[Tuple, int]" = \
            collections.OrderedDict()  # sig -> compile count
        self.compiles = 0
        self.compile_s = 0.0
        self.hits = 0
        self.dispatches = 0
        self.traces = 0  # stays 0: nothing re-traces in the port
        self.warmup = 0
        self.cold = 0
        self.rogue = 0
        self.persist_hits = 0
        # sig -> (wall seconds, class) of its first compile: the card's
        # first-launch cost per signature, listed by dump()
        self.first_s: Dict[Tuple, Tuple[float, str]] = {}


class _XlaPerf(PerfCounters):
    """The ``osd.N.xla`` set: the reference's counters, plus what only
    the port has (the build's seconds, launches per kernel, the queue's
    batches), read at dump time."""

    def __init__(self, watch: "DeviceWatch") -> None:
        super().__init__("tpu.xla")
        self._watch = watch

    def dump(self) -> Dict[str, object]:
        out = super().dump()
        w = self._watch
        out["build_seconds"] = _build.build_seconds or 0.0
        out.update({f"launches_{k}": v for k, v in w.launches().items()})
        with w._lock:
            out["batches"] = w.batches
            out["batch_seconds"] = round(w.batch_seconds, 6)
        return out


class DeviceWatch:
    """Process-wide device-runtime watcher; see the module docstring."""

    def __init__(self) -> None:
        self._lock = make_lock("devwatch")
        self.perf = _XlaPerf(self)
        self.perf.add_u64_counter(
            "compile_total", "first launches and builds (all families)")
        self.perf.add_time_avg(
            "compile_seconds", "wall seconds of first launches and builds")
        self.perf.add_u64_gauge(
            "distinct_shapes", "distinct launch signatures, all families")
        self.perf.add_u64_counter(
            "cache_hits", "launches at a signature already launched")
        self.perf.add_u64_counter(
            "recompile_storms", "recompile-storm WARNs raised")
        self.perf.add_u64_counter(
            "rogue_compiles",
            "first launches with a signature OUTSIDE the declared bucket "
            "set (shape-bucket ABI violation)")
        self.perf.add_u64_counter(
            "warmup_compiles",
            "declared-bucket first launches paid inside a warmup pass")
        self.perf.add_u64_counter(
            "cache_persist_hits",
            "kernel builds loaded from ceph_tpu_torch/_build/ without "
            "compiling (a previous process paid the wall)")
        self.perf.add_u64_counter(
            "cache_persist_misses",
            "kernel builds compiled by this process")
        self._fams: Dict[str, _Family] = {}
        # instrumented_launch's seen signatures, per family
        self._seen: Dict[str, set] = {}
        # flight recorder: (t_mono, kind, family, detail)
        self._events: Deque[Tuple[float, str, str, str]] = \
            collections.deque(maxlen=_EVENT_RING)
        # finished compile spans (t0, t1) + live compiles for the
        # queue's blame query; monotonic clock throughout
        self._spans: Deque[Tuple[float, float]] = \
            collections.deque(maxlen=_SPAN_RING)
        self._live: Dict[int, Tuple[str, float, int]] = {}
        self._live_seq = 0
        # storm detection: (t, family, sig, rogue) of recent compiles
        self._recent: Deque[Tuple[float, str, Tuple, bool]] = \
            collections.deque(maxlen=_SPAN_RING)
        self.storm_window_s = DEFAULT_STORM_WINDOW_S
        self.storm_min_sigs = DEFAULT_STORM_MIN_SIGS
        self.storm_min_rogue_sigs = DEFAULT_STORM_MIN_ROGUE_SIGS
        self._warmup = 0  # > 0 while a DeviceWarmup pass runs
        # last published DeviceWarmup stats (the dump's warmup section)
        self.warmup_stats: Optional[Dict[str, Any]] = None
        self._persist_hits = 0
        self._persist_misses = 0
        # monotonic stamp of the last compile end (0.0 = never)
        self.last_compile_end = 0.0
        self._storm_last: Dict[str, float] = {}
        self.storms: List[Dict[str, Any]] = []   # bounded below
        self._steady = 0  # steady-state section depth
        self._log = None  # core.log.Log (gather ring + cluster WRN)
        self._queue = None  # the queue device_state() reports
        # the queue's batches: (t_mono, kind, jobs, shapes, seconds)
        self._batches: Deque[Tuple[float, str, int, List, float]] = \
            collections.deque(maxlen=_BATCH_RING)
        self.batches = 0
        self.batch_seconds = 0.0

    # -- wiring ------------------------------------------------------------
    def attach_log(self, log) -> None:
        """Compile and batch events land in ``log``'s gather ring (subsys
        ``tpu``) and storm WRNs ride its cluster channel.  The latest
        attach wins: daemons of one process share the watch, and a
        revived daemon re-attaches."""
        self._log = log

    def attach_queue(self, queue) -> None:
        """The queue whose depth and staging :meth:`device_state`
        reports (None detaches)."""
        self._queue = queue

    def configure(self, window_s: Optional[float] = None,
                  min_sigs: Optional[int] = None,
                  min_rogue_sigs: Optional[int] = None) -> None:
        if window_s is not None and window_s > 0:
            self.storm_window_s = float(window_s)
        if min_sigs is not None and min_sigs > 0:
            self.storm_min_sigs = int(min_sigs)
        if min_rogue_sigs is not None and min_rogue_sigs > 0:
            self.storm_min_rogue_sigs = int(min_rogue_sigs)

    # -- per-family plumbing -------------------------------------------------
    def _fam(self, family: str) -> _Family:
        # callers hold self._lock
        f = self._fams.get(family)
        if f is None:
            f = self._fams[family] = _Family()
            self.perf.add_u64_counter(
                f"compile_{family}_total", f"{family} first launches")
            self.perf.add_histogram(
                f"exec_{family}_us",
                f"{family} dispatch wall per seen-signature launch (us)")
        return f

    def _record(self, kind: str, family: str, detail: str,
                level: int, lines: List[Tuple[int, str]]) -> None:
        # callers hold self._lock; the log line is written by
        # _flush after the lock is released
        self._events.append((time.monotonic(), kind, family, detail))
        lines.append((level, f"devwatch {kind} {family}: {detail}"))

    def _flush(self, lines: List[Tuple[int, str]]) -> None:
        log = self._log
        if log is not None:
            for level, msg in lines:
                log.log("tpu", level, msg)

    # -- compile lifecycle -------------------------------------------------
    def compile_begin(self, family: str) -> int:
        t0 = time.monotonic()
        with self._lock:
            self._live_seq += 1
            tok = self._live_seq
            self._live[tok] = (family, t0, self._persist_hits)
        return tok

    def compile_end(self, token: int, sig: Tuple,
                    error: bool = False) -> None:
        t1 = time.monotonic()
        with self._lock:
            family, t0, persist0 = self._live.pop(token, ("?", t1, 0))
        self._end(family, sig, t0, t1, persist0, error)

    def _end(self, family: str, sig: Tuple, t0: float, t1: float,
             persist0: int, error: bool) -> None:
        # classify against the declared shape-bucket ABI outside the
        # lock (a registry lookup; lazy import: shapebucket imports
        # this module)
        from ceph_tpu_torch.gpu import shapebucket

        declared = shapebucket.sig_declared(family, sig)
        lines: List[Tuple[int, str]] = []
        storm = None
        with self._lock:
            self._spans.append((t0, t1))
            self.last_compile_end = t1
            if error:
                self._record("compile", family,
                             f"FAILED sig=({sig_str(sig)})", 1, lines)
            else:
                storm = self._count(family, sig, t0, t1, persist0,
                                    declared, lines)
        self._flush(lines)
        if storm is not None:
            self._warn_storm(storm)

    def _count(self, family, sig, t0, t1, persist0, declared, lines):
        # callers hold self._lock
        wall = t1 - t0
        fam = self._fam(family)
        fam.compiles += 1
        fam.compile_s += wall
        fam.sigs[sig] = fam.sigs.get(sig, 0) + 1
        self.perf.inc("compile_total")
        self.perf.inc(f"compile_{family}_total")
        self.perf.tinc("compile_seconds", wall)
        self.perf.set("distinct_shapes",
                      sum(len(f.sigs) for f in self._fams.values()))
        if not declared:
            klass = "rogue"
            fam.rogue += 1
            self.perf.inc("rogue_compiles")
        elif self._warmup > 0:
            klass = "warmup"
            fam.warmup += 1
            self.perf.inc("warmup_compiles")
        else:
            klass = "bucketed-cold"
            fam.cold += 1
        fam.first_s.setdefault(sig, (wall, klass))
        persist_d = self._persist_hits - persist0
        if persist_d > 0:
            fam.persist_hits += persist_d
        # warmup-classified compiles never feed the storm window (a
        # warmup walks the declared ladder by design); rogues always do
        if klass != "warmup":
            self._recent.append((t1, family, sig, not declared))
        self._record(
            "compile", family,
            f"[{klass}] sig=({sig_str(sig)}) wall_ms={wall * 1e3:.1f}"
            + (" persist-hit" if persist_d > 0 else ""),
            1 if klass == "rogue" else 10, lines)
        if self._steady > 0:
            GUARD_VIOLATIONS.append(
                f"first launch inside a steady-state section: "
                f"family={family} class={klass} "
                f"sig=({sig_str(sig)}) "
                f"wall_ms={wall * 1e3:.1f} — warm this shape up "
                "front or pad it into an already-launched bucket")
        return self._check_storm(family, t1)

    def note_build(self, t0: float, t1: float, hit: bool) -> None:
        """The kernel build ran from ``t0`` to ``t1`` (monotonic): one
        compile of :data:`BUILD_FAMILY`, a persist hit when it loaded a
        library already built."""
        with self._lock:
            persist0 = self._persist_hits
        self.note_persist(hit)
        self._end(BUILD_FAMILY, tuple(("val", repr(s))
                                      for s in _build.SOURCES),
                  t0, t1, persist0, False)

    def note_persist(self, hit: bool) -> None:
        """One kernel build: a hit loaded a library some previous process
        built, a miss compiled it here."""
        with self._lock:
            if hit:
                self._persist_hits += 1
                self.perf.inc("cache_persist_hits")
            else:
                self._persist_misses += 1
                self.perf.inc("cache_persist_misses")

    def persist_totals(self) -> Tuple[int, int]:
        with self._lock:
            return self._persist_hits, self._persist_misses

    @contextlib.contextmanager
    def warmup_scope(self):
        """Class first launches as ``warmup`` (declared buckets paid up
        front by a DeviceWarmup pass, not charged as cold)."""
        with self._lock:
            self._warmup += 1
        try:
            yield self
        finally:
            with self._lock:
                self._warmup -= 1

    def note_hit(self, family: str, dur_s: float) -> None:
        with self._lock:
            fam = self._fam(family)
            fam.hits += 1
            fam.dispatches += 1
            self.perf.inc("cache_hits")
            self.perf.hinc(f"exec_{family}_us", dur_s * 1e6)

    def note_trace(self, family: str) -> None:
        """The reference's pallas trace re-entry count; nothing in the
        port re-traces a kernel body, so no wrapper calls it."""
        with self._lock:
            self._fam(family).traces += 1

    def note_batch(self, kind: str, jobs: int, shapes: List[Tuple],
                   dur_s: float) -> None:
        """One stripe-batch queue dispatch that completed: its kind, job
        count, per-job plane shapes and upload + compute + download
        seconds."""
        lines: List[Tuple[int, str]] = []
        with self._lock:
            self._batches.append((time.monotonic(), kind, int(jobs),
                                  [list(s) for s in shapes], float(dur_s)))
            self.batches += 1
            self.batch_seconds += float(dur_s)
            self._record("batch", "queue",
                         f"kind={kind} jobs={jobs} shapes={shapes} "
                         f"dur_ms={dur_s * 1e3:.1f}", 15, lines)
        self._flush(lines)

    # -- storm detection ---------------------------------------------------
    def _check_storm(self, family: str,
                     now: float) -> Optional[Dict[str, Any]]:
        # callers hold self._lock.  Rogue signatures trip at the tight
        # count, declared ones at the loose total (a declared ladder is
        # finite by construction)
        horizon = now - self.storm_window_s
        recent = [(s, r) for (t, f, s, r) in self._recent
                  if f == family and t >= horizon]
        distinct = list(dict.fromkeys(s for s, _r in recent))
        rogue_distinct = list(dict.fromkeys(
            s for s, r in recent if r))
        if len(rogue_distinct) >= self.storm_min_rogue_sigs:
            kind, storm_sigs = "rogue", rogue_distinct
        elif len(distinct) >= self.storm_min_sigs:
            kind, storm_sigs = "declared", distinct
        else:
            return None
        last = self._storm_last.get(family, 0.0)
        if now - last < self.storm_window_s:
            return None  # one WARN per family per window
        self._storm_last[family] = now
        dim = _churn_dim(storm_sigs)
        storm = {
            "family": family,
            "kind": kind,
            "distinct_signatures": len(storm_sigs),
            "rogue_signatures": len(rogue_distinct),
            "window_s": self.storm_window_s,
            "churning": dim,
            "signatures": [sig_str(s)
                           for s in storm_sigs[-_SIGS_KEPT:]],
            "at": time.time(),
        }
        self.storms.append(storm)
        del self.storms[:-16]
        self.perf.inc("recompile_storms")
        self._events.append((time.monotonic(), "storm", family,
                             f"[{kind}] {len(storm_sigs)} distinct sigs in "
                             f"{self.storm_window_s:.0f}s, churning {dim}"))
        return storm

    def _warn_storm(self, storm: Dict[str, Any]) -> None:
        # outside self._lock: the cluster callback may take any lock
        log = self._log
        what = ("undeclared (rogue) shape signatures"
                if storm.get("kind") == "rogue"
                else "distinct shape signatures")
        msg = (f"RECOMPILE_STORM: kernel family "
               f"'{storm['family']}' compiled "
               f"{storm['distinct_signatures']} {what} "
               f"within {storm['window_s']:.0f}s "
               f"(churning dimension: {storm['churning']}) — pad the "
               "churning dimension to a declared bucket "
               "(shapebucket.covering, the repo-wide shape ABI)")
        if log is not None:
            log.log("tpu", 1, f"devwatch storm {storm['family']}: "
                              f"[{storm['kind']}] "
                              f"{storm['distinct_signatures']} distinct "
                              f"sigs in {storm['window_s']:.0f}s, churning "
                              f"{storm['churning']}")
            log.cluster("WRN", msg)

    # -- steady-state guard ------------------------------------------------
    @contextlib.contextmanager
    def steady_state(self):
        """Declare "warmup is done": a first launch or a build inside
        this section lands in :data:`GUARD_VIOLATIONS`."""
        with self._lock:
            self._steady += 1
        try:
            yield self
        finally:
            with self._lock:
                self._steady -= 1

    # -- queries -----------------------------------------------------------
    def compile_activity_since(self, t0: float) -> bool:
        """Cheap pre-check of the queue's blame loop: False means no
        compile is live (the build included) and none finished after
        ``t0``, so no overlap query over [t0, now] can be nonzero."""
        b0, b1 = _build.build_t0, _build.build_t1
        return (bool(self._live) or self.last_compile_end > t0
                or (b0 is not None and b1 is None))

    def compile_overlap_s(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] (monotonic) overlapped by any compile:
        finished first launches and builds, live first launches and a
        build still running."""
        if t1 <= t0:
            return 0.0
        total = 0.0
        now = time.monotonic()
        with self._lock:
            spans = list(self._spans)
            spans += [(s0, now) for (_f, s0, _p) in self._live.values()]
        b0, b1 = _build.build_t0, _build.build_t1
        if b0 is not None and b1 is None:
            spans.append((b0, now))
        for s0, s1 in spans:
            lo, hi = max(t0, s0), min(t1, s1)
            if hi > lo:
                total += hi - lo
        return min(total, t1 - t0)

    def compile_totals(self) -> Dict[str, float]:
        """Cumulative compile totals, the per-phase delta source."""
        with self._lock:
            return {
                "compiles": sum(f.compiles for f in self._fams.values()),
                "compile_seconds": round(
                    sum(f.compile_s for f in self._fams.values()), 6),
                "rogue": sum(f.rogue for f in self._fams.values()),
                "warmup": sum(f.warmup for f in self._fams.values()),
                "persist_hits": self._persist_hits,
            }

    def family_stats(self, family: str) -> Dict[str, Any]:
        with self._lock:
            f = self._fams.get(family)
            if f is None:
                return {"compiles": 0, "compile_s": 0.0,
                        "distinct_signatures": 0, "cache_hits": 0,
                        "dispatches": 0, "traces": 0,
                        "warmup": 0, "cold": 0, "rogue": 0,
                        "persist_hits": 0}
            return {"compiles": f.compiles,
                    "compile_s": round(f.compile_s, 6),
                    "distinct_signatures": len(f.sigs),
                    "cache_hits": f.hits, "dispatches": f.dispatches,
                    "traces": f.traces,
                    "warmup": f.warmup, "cold": f.cold,
                    "rogue": f.rogue,
                    "persist_hits": f.persist_hits}

    @staticmethod
    def launches() -> Dict[str, int]:
        """Launches per kernel since each count was last reset."""
        # the kernel wrappers import this module; importing them here
        # creates every launch count before it is read
        from ceph_tpu_torch.ops import (crc32c_device, crush_rule,  # noqa
                                        gf2_matmul, gf256, gf256_planes,
                                        mesh_digest)

        return {c.name: c.value for c in _build.COUNTS}

    @staticmethod
    def build() -> Dict[str, Any]:
        return {"built": _build.build_seconds is not None,
                "seconds": _build.build_seconds,
                "persist_hit": _build.build_hit,
                "live": (_build.build_t0 is not None
                         and _build.build_t1 is None),
                "dir": str(_build.BUILD_DIR),
                "sources": list(_build.SOURCES)}

    def _recent_batches(self, now: float, n: int) -> List[Dict[str, Any]]:
        # callers hold self._lock
        return [{"age_s": round(now - t, 3), "kind": kind, "jobs": jobs,
                 "shapes": shapes, "seconds": round(dur, 6)}
                for t, kind, jobs, shapes, dur in list(self._batches)[-n:]]

    def first_launches(self) -> List[Dict[str, Any]]:
        """Every family's signatures in first-launch order, each with the
        wall and class of its first launch (its "compile")."""
        with self._lock:
            return [{"family": name, "sig": sig_str(s),
                     "wall_s": round(wall, 6), "class": klass}
                    for name, f in sorted(self._fams.items())
                    for s, (wall, klass) in f.first_s.items()]

    def dump(self) -> Dict[str, Any]:
        """The ``device compile dump`` payload: the reference's compile
        table, storms, live compiles and event tail, then the kernel
        build, launches per kernel and the queue's batches."""
        from ceph_tpu_torch.gpu import shapebucket

        now = time.monotonic()
        launches = self.launches()
        with self._lock:
            fams = {}
            for name, f in sorted(self._fams.items()):
                fams[name] = {
                    "compiles": f.compiles,
                    "compile_s": round(f.compile_s, 6),
                    "distinct_signatures": len(f.sigs),
                    "cache_hits": f.hits,
                    "dispatches": f.dispatches,
                    "traces": f.traces,
                    "warmup": f.warmup,
                    "cold": f.cold,
                    "rogue": f.rogue,
                    "persist_hits": f.persist_hits,
                    "signatures": [
                        {"sig": sig_str(s), "compiles": n}
                        for s, n in list(f.sigs.items())[-_SIGS_KEPT:]],
                }
            live = [{"family": fam, "age_s": round(now - t0, 3)}
                    for fam, t0, _p in self._live.values()]
            events = [
                {"age_s": round(now - t, 3), "kind": k,
                 "family": fam, "detail": d}
                for t, k, fam, d in list(self._events)[-50:]]
            return {
                "families": fams,
                "totals": {
                    "compiles": sum(x.compiles
                                    for x in self._fams.values()),
                    "compile_seconds": round(
                        sum(x.compile_s for x in self._fams.values()),
                        6),
                    "distinct_shapes": sum(
                        len(x.sigs) for x in self._fams.values()),
                    "cache_hits": sum(x.hits
                                      for x in self._fams.values()),
                    "rogue_compiles": sum(
                        x.rogue for x in self._fams.values()),
                    "warmup_compiles": sum(
                        x.warmup for x in self._fams.values()),
                    "cache_persist_hits": self._persist_hits,
                    "cache_persist_misses": self._persist_misses,
                },
                "warmup": self.warmup_stats,
                "compile_cache_dir": shapebucket.compile_cache_dir(),
                "storms": list(self.storms),
                "live_compiles": live,
                "recent_events": events,
                "build": self.build(),
                "launches": launches,
                "batches": {"total": self.batches,
                            "seconds": round(self.batch_seconds, 6),
                            "recent": self._recent_batches(
                                now, _DUMP_BATCHES)},
            }

    def device_state(self) -> Dict[str, Any]:
        """The crash-report device section: the queue's depth, staging
        occupancy and in-flight batch, live compiles, the last compile
        events and storms, the kernel build, the launches and the last
        batches."""
        now = time.monotonic()
        out: Dict[str, Any] = {}
        q = self._queue
        if q is not None:
            try:
                out["queue_depth"] = q._q.qsize()
                out["staging_slots_used"] = q.pool.occupancy
                out["staging"] = q.stats.snapshot()
                out["in_flight_batch"] = q.inflight_batch()
            except Exception as e:  # a torn queue must not kill the
                out["queue_error"] = repr(e)  # crash report itself
        out["build"] = self.build()
        out["launches"] = self.launches()
        with self._lock:
            out["live_compiles"] = [
                {"family": fam, "age_s": round(now - t0, 3)}
                for fam, t0, _p in self._live.values()]
            out["last_compiles"] = [
                {"age_s": round(now - t, 3), "family": fam,
                 "detail": d}
                for t, k, fam, d in list(self._events)
                if k == "compile"][-10:]
            out["storms"] = list(self.storms)
            out["last_batches"] = self._recent_batches(now, _STATE_BATCHES)
        return out

    # -- Prometheus (family-labeled cluster metrics) -----------------------
    def export_prometheus(self, lines: List[str]) -> None:
        """Family-labeled ``ceph_xla_*`` exposition lines, the
        reference's names, labels and ``le="+Inf"`` rule (dashboards
        read them).  On the card: ``ceph_xla_compile_total`` counts each
        family's first launches (and the build), ``_compile_seconds``
        their walls, ``_distinct_shapes`` its signatures,
        ``_cache_hits`` its launches at a seen signature,
        ``_rogue_compiles`` its first launches outside the declared
        buckets, ``_cache_persist_hits`` builds loaded without
        compiling, and ``ceph_xla_exec_us`` the dispatch wall of its
        seen-signature launches."""
        with self._lock:
            fams = sorted(self._fams.items())
            if not fams:
                return
            rows = [(name, f.compiles, round(f.compile_s, 6),
                     len(f.sigs), f.hits, f.rogue, f.persist_hits)
                    for name, f in fams]
        for metric, idx, typ in (
                ("ceph_xla_compile_total", 1, "counter"),
                ("ceph_xla_compile_seconds", 2, "counter"),
                ("ceph_xla_distinct_shapes", 3, "gauge"),
                ("ceph_xla_cache_hits", 4, "counter"),
                ("ceph_xla_rogue_compiles", 5, "counter"),
                ("ceph_xla_cache_persist_hits", 6, "counter")):
            lines.append(f"# TYPE {metric} {typ}")
            for row in rows:
                lines.append(
                    f'{metric}{{family="{row[0]}"}} {row[idx]}')
        hists = self.perf.dump()
        lines.append("# TYPE ceph_xla_exec_us histogram")
        for name, *_rest in rows:
            val = hists.get(f"exec_{name}_us")
            if not isinstance(val, dict):
                continue
            label = f'family="{name}"'
            acc = 0
            for i, b in enumerate(val.get("buckets", [])):
                acc += b
                lines.append(
                    f'ceph_xla_exec_us_bucket{{{label},'
                    f'le="{1 << i}"}} {acc}')
            lines.append(
                f'ceph_xla_exec_us_bucket{{{label},le="+Inf"}} '
                f'{val["count"]}')
            lines.append(
                f'ceph_xla_exec_us_count{{{label}}} {val["count"]}')
            lines.append(
                f'ceph_xla_exec_us_sum{{{label}}} {val["sum"]}')


_WATCH = DeviceWatch()
_build.BUILD_LISTENERS.append(_WATCH.note_build)
if _build.build_hit is not None:
    # the build ran before this module was first imported
    _WATCH.note_build(_build.build_t0, _build.build_t1, _build.build_hit)


def watch() -> DeviceWatch:
    """The process-wide watcher: one device runtime per process."""
    return _WATCH


def instrumented_launch(family: str, sig: Tuple, fn: Callable[[], Any],
                        device=None) -> Any:
    """Run ``fn`` (one kernel wrapper's launch, or its plain version on
    the CPU) and record it in ``family``'s table.

    The first launch at ``sig`` in this process is a compile: timed from
    before ``fn`` to after one synchronize of ``device``'s current
    stream when ``device`` is a CUDA device and the stream is not being
    captured, classed by ``gpu/shapebucket.py``.  On a CUDA device the
    kernel build runs first, outside that span (it is its own compile).
    Two threads launching one new signature at once count it once.  A
    launch at a seen signature is a hit timed without a synchronize.  A
    launch that raises is recorded as ``FAILED`` and re-raised, and its
    signature stays unseen."""
    w = _WATCH
    with w._lock:
        seen = w._seen.setdefault(family, set())
        first = sig not in seen
        if first:
            seen.add(sig)
    if not first:
        t0 = time.monotonic()
        out = fn()
        w.note_hit(family, time.monotonic() - t0)
        return out
    cuda = device is not None and getattr(device, "type", None) == "cuda"
    if cuda:
        _build.lib()
    tok = w.compile_begin(family)
    failed = True
    try:
        out = fn()
        if cuda:
            import torch

            if not torch.cuda.is_current_stream_capturing():
                torch.cuda.current_stream(device).synchronize()
        failed = False
    finally:
        if failed:
            with w._lock:
                seen.discard(sig)
        w.compile_end(tok, sig, error=failed)
    return out
