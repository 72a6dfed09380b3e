"""Multi-tenant QoS admission subsystem — dmClock in command of the
OSD op path.

Reference seams: the mClock scheduler family behind
``osd_op_queue=mclock_scheduler`` (src/osd/scheduler/mClockScheduler.cc
over src/dmclock/), the per-class profiles of
``mclock_profile``/``osd_mclock_scheduler_*``, and the client
Throttle pair ``osd_client_message_cap`` /
``osd_client_message_size_cap`` (src/osd/OSD.cc client_messenger
policy throttles).  Four roles live here:

1. **Scheduled admission.**  ``QosScheduler`` owns the dmClock shard
   queues the daemon's ``ShardedWorkQueue`` dequeues through.  Ops are
   classified by op class AND tenant: ``classify_op`` maps an MOSDOp
   to a queue class (``client``, ``snaptrim``, or a tenant/pool
   override class from the conf-driven profile registry) and a COST in
   scheduler units — payload bytes over :data:`COST_UNIT_BYTES`, so a
   64 KiB write is charged 16x a 4 KiB one and a byte-heavy tenant
   cannot hide behind an op-count-fair scheduler.  Admission order is
   decided ACROSS objects only: the PG's ``_OidPipe`` per-object FIFO
   runs downstream of the workqueue, untouched, so same-object writes
   keep their strict order no matter what the scheduler does.

2. **Background work as tenants.**  The recovery window asks
   :meth:`recovery_window` for its round width, and a feedback
   controller closes the loop the old fixed window left open: when the
   client-IOPS signal (the same cumulative counters the PGMap
   digest rates are derived from, read through a local SnapshotRing —
   or a wired-in digest rate fn) shows clients idle, recovery's
   effective window widens; under client pressure it clamps.  Snaptrim
   sweeps charge each trimmed object to the ``snaptrim`` class through
   :meth:`background_pause` (a token bucket over the class limit).

3. **Edge backpressure** is the messenger's job
   (``Messenger.set_dispatch_gate``): per-connection in-flight op/byte
   caps make an abusive tenant queue at ITS socket (TCP backpressure)
   instead of inside the shared workqueue.  This module only carries
   the conf knobs and folds the stall counters into ``qos status``.

4. **Evidence.**  Every admit/dequeue feeds the ``osd.N.qos`` perf set
   (per-class admitted counters + wait histograms, dequeue-phase
   counters, recovery-window gauge), dequeue marks the op's
   ``qos_admitted`` stage (``lat_qos_wait_us`` in the optracker's STAGES
   timeline), and :meth:`status` is the payload behind the
   ``qos status`` admin/mgr/CLI command, the ``ceph_qos_*`` Prometheus
   gauges, and cephtop's ``--qos`` pane.

Profile spec DSL (conf ``osd_qos_profiles``, runtime-updatable —
``qos set`` retunes through the conf observer)::

    <target>=<reservation>:<weight>:<limit>[;<target>=...]
    target:  <base class>         client=500:100:0
             tenant:<entity>      tenant:client.42=200:100:0
             pool:<id>            pool:7=50:10:100

Tenant profiles win over pool profiles over base classes.  Tenant and
pool overrides mint their own queue class (``client/<entity>`` /
``pool/<id>``) so dmClock arbitrates them as first-class tenants; ops
matching no override ride their base class.

Port of ``ceph_tpu/osd/qos.py``, all of it: the same classes, costs,
profile grammar, counters and ``qos status`` payload.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.perf import SnapshotRing, hist_summary
from ceph_tpu_torch.osd.mclock import (DEFAULT_CLASSES, ClientInfo,
                                       MClockQueue, PHASE_FALLBACK,
                                       PHASE_PRIORITY, PHASE_RESERVATION)

# one scheduler cost unit = this many payload bytes (ops charge
# max(1, bytes/unit) so metadata ops still cost one unit)
COST_UNIT_BYTES = 4096

# base class names valid at enqueue sites (`qos_class=` literals are
# held to this table by the reference's qos-class-registry lint check, the
# failpoint-name-registry shape: a typo'd class silently rides
# best_effort and the profile the site meant to claim never applies)
KNOWN_QOS_CLASSES = frozenset(DEFAULT_CLASSES)

# dequeue phases a fifo-mode workqueue reports (the A/B arm's stamp)
PHASE_FIFO = "fifo"

# floats accept e-notation: merge_profile_spec serializes with %g,
# and a spec that serializes but cannot re-parse would poison the conf
_F = r"[0-9.]+(?:[eE][+-]?[0-9]+)?"
_SPEC_RE = re.compile(
    rf"^(?P<target>[A-Za-z0-9_.:-]+)=(?P<r>{_F}):(?P<w>{_F})"
    rf":(?P<l>{_F})$")


def _sane(name: str) -> str:
    """Perf-counter-safe spelling of a queue class name."""
    return re.sub(r"[^0-9A-Za-z_]", "_", name)


def parse_profile_spec(spec: str) -> List[Tuple[str, ClientInfo]]:
    """``osd_qos_profiles`` DSL -> [(target, ClientInfo)].  Raises
    ValueError on malformed entries or unknown base classes — a typo'd
    profile must fail the set_val, not silently schedule nothing."""
    out: List[Tuple[str, ClientInfo]] = []
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        m = _SPEC_RE.match(raw)
        if m is None:
            raise ValueError(f"osd_qos_profiles: bad entry {raw!r} "
                             "(want target=r:w:l)")
        target = m.group("target")
        if ":" in target:
            kind, sel = target.split(":", 1)
            if kind not in ("tenant", "pool"):
                raise ValueError(
                    f"osd_qos_profiles: unknown selector {kind!r} in "
                    f"{raw!r} (want tenant:<entity> or pool:<id>)")
            if kind == "pool":
                try:
                    int(sel)
                except ValueError:
                    # reject HERE: apply_spec's rebuild must never
                    # fail halfway (it resets the registry first)
                    raise ValueError(
                        f"osd_qos_profiles: pool id {sel!r} is not an "
                        f"integer in {raw!r}")
        elif target not in KNOWN_QOS_CLASSES:
            raise ValueError(
                f"osd_qos_profiles: {target!r} is not a QoS class "
                f"(known: {sorted(KNOWN_QOS_CLASSES)})")
        info = ClientInfo(reservation=float(m.group("r")),
                          weight=float(m.group("w")),
                          limit=float(m.group("l")))
        out.append((target, info))
    return out


def merge_profile_spec(spec: str, target: str, reservation: float,
                       weight: float, limit: float) -> str:
    """One-target retune folded into an existing spec string (the
    ``qos set`` -> conf-observer path): the conf value stays the
    single durable source of truth for every override."""
    entries = dict(parse_profile_spec(spec))  # validates the old spec
    entries[target] = ClientInfo(reservation=float(reservation),
                                 weight=float(weight),
                                 limit=float(limit))
    merged = ";".join(
        f"{t}={i.reservation:g}:{i.weight:g}:{i.limit:g}"
        for t, i in sorted(entries.items()))
    # the merged spec must round-trip BEFORE anyone commits it to
    # conf: set_val stores the value and only then fires observers, so
    # a spec that cannot re-parse would permanently poison
    # osd_qos_profiles (every later retune — and every OSD boot on
    # that ctx — would fail on it)
    parse_profile_spec(merged)
    return merged


class QosProfileRegistry:
    """Class/tenant/pool triple table (conf-driven, retunable)."""

    def __init__(self, spec: str = "") -> None:
        self._lock = make_lock("qos.registry")
        self.classes: Dict[str, ClientInfo] = dict(DEFAULT_CLASSES)
        self.tenants: Dict[str, ClientInfo] = {}
        self.pools: Dict[int, ClientInfo] = {}
        if spec:
            self.apply_spec(spec)

    def apply_spec(self, spec: str) -> None:
        parsed = parse_profile_spec(spec)  # all-or-nothing validation
        with self._lock:
            # conf is authoritative: overrides absent from the new
            # spec revert (their queue classes fall back through
            # info_for to the base triple)
            self.classes = dict(DEFAULT_CLASSES)
            self.tenants = {}
            self.pools = {}
            for target, info in parsed:
                if target.startswith("tenant:"):
                    self.tenants[target.split(":", 1)[1]] = info
                elif target.startswith("pool:"):
                    self.pools[int(target.split(":", 1)[1])] = info
                else:
                    self.classes[target] = info

    def set_triple(self, target: str, info: ClientInfo) -> None:
        with self._lock:
            if target.startswith("tenant:"):
                self.tenants[target.split(":", 1)[1]] = info
            elif target.startswith("pool:"):
                self.pools[int(target.split(":", 1)[1])] = info
            elif target in KNOWN_QOS_CLASSES:
                self.classes[target] = info
            else:
                raise ValueError(f"unknown qos target {target!r}")

    def resolve(self, base_cls: str, tenant: Optional[str] = None,
                pool: Optional[int] = None) -> str:
        """Queue class for one op: tenant override > pool override >
        base class.  Background classes (recovery/scrub/snaptrim)
        never tenant-split — they are the cluster's own tenants."""
        with self._lock:
            if base_cls == "client":
                if tenant is not None and tenant in self.tenants:
                    return f"client/{tenant}"
                if pool is not None and pool in self.pools:
                    return f"pool/{pool}"
            return base_cls

    def info_for(self, queue_cls: str) -> ClientInfo:
        """Triple for a queue class (the MClockQueue resolver)."""
        with self._lock:
            if queue_cls.startswith("client/"):
                info = self.tenants.get(queue_cls.split("/", 1)[1])
                if info is not None:
                    return info
                return self.classes["client"]
            if queue_cls.startswith("pool/"):
                try:
                    info = self.pools.get(int(queue_cls.split("/", 1)[1]))
                except ValueError:
                    info = None
                if info is not None:
                    return info
                return self.classes["client"]
            return self.classes.get(
                queue_cls, self.classes["best_effort"])

    def dump(self) -> Dict[str, Dict[str, float]]:
        def row(i: ClientInfo) -> Dict[str, float]:
            return {"reservation": i.reservation, "weight": i.weight,
                    "limit": i.limit}

        with self._lock:
            out = {name: row(i) for name, i in sorted(self.classes.items())}
            out.update({f"tenant:{t}": row(i)
                        for t, i in sorted(self.tenants.items())})
            out.update({f"pool:{p}": row(i)
                        for p, i in sorted(self.pools.items())})
            return out


class _TokenBucket:
    """Rate pacing for background sweeps (the snaptrim grant): charge()
    returns the seconds the caller should pause so its long-run rate
    stays at the class limit — the sleeper owns the wait (interruptible
    by its shutdown event), the bucket only does arithmetic.  Debt is
    BOUNDED to ``max_debt_s``: callers may cap their actual pause (the
    snaptrim sweep caps per-object waits so it never holds its shard
    long), and uncapped accounting would bank the shortfall forever —
    one long sweep would then throttle every later idle-cluster sweep
    against minutes of phantom debt."""

    MAX_DEBT_S = 1.0

    def __init__(self, rate: float, clock=time.monotonic) -> None:
        self.clock = clock
        self.rate = rate
        self._lock = make_lock("qos.bucket")
        self._next_free = 0.0

    def charge(self, n: float = 1.0) -> float:
        if self.rate <= 0:
            return 0.0
        now = self.clock()
        with self._lock:
            start = max(self._next_free, now)
            self._next_free = min(start + n / self.rate,
                                  now + self.MAX_DEBT_S)
            return max(0.0, start - now)


class QosScheduler:
    """One per OSD daemon: the registry + shard queues + feedback
    controller + evidence surface (module docstring)."""

    def __init__(self, conf, perf=None, clock=time.monotonic,
                 client_rate_fn: Optional[Callable[[], float]] = None
                 ) -> None:
        self.conf = conf
        self.clock = clock
        self.perf = perf
        mode = str(conf.get("osd_op_queue"))
        # "fifo" is the operator-facing A/B spelling; "wpq" the
        # legacy internal one — same priority-heap scheduler
        self.mode = "mclock" if mode == "mclock" else "fifo"
        self.registry = QosProfileRegistry(
            str(conf.get("osd_qos_profiles") or ""))
        self._lock = make_lock("qos.scheduler")
        self._queues: List[MClockQueue] = []
        # client-pressure signal: cumulative admitted client ops in a
        # rate ring — the SAME counter family the PGMap digest derives
        # client IOPS from, read locally so the controller works
        # without a mon; wire client_rate_fn to a digest for the
        # cluster-wide signal instead
        self._client_ops = 0
        self._ring = SnapshotRing(capacity=128)
        self.client_rate_fn = client_rate_fn
        # recovery feedback evidence
        self._recovery_state = "steady"
        self._recovery_eff = 0
        self._recovery_widened = 0
        self._recovery_clamped = 0
        self._recovery_granted = 0
        # background sweep pacing: one token bucket per paced class
        # (snaptrim object trims, scrub chunk reads), each tracking
        # its class limit
        self._bg_buckets: Dict[str, _TokenBucket] = {}
        if perf is not None:
            perf.add_u64_counter("dequeue_reservation",
                                 "dequeues granted by a due "
                                 "reservation tag (phase 1)")
            perf.add_u64_counter("dequeue_priority",
                                 "dequeues granted by proportional "
                                 "share (phase 2)")
            perf.add_u64_counter("dequeue_fallback",
                                 "work-conserving dequeues with every "
                                 "class limit-throttled")
            perf.add_u64_counter("dequeue_fifo",
                                 "dequeues under the fifo scheduler "
                                 "(A/B arm)")
            perf.add_u64_gauge("recovery_window_effective",
                               "recovery round width after feedback")
            perf.add_u64_counter("recovery_widened",
                                 "recovery grants taken with the "
                                 "window widened (clients idle)")
            perf.add_u64_counter("recovery_clamped",
                                 "recovery grants taken with the "
                                 "window clamped (client pressure)")

    # -- shard queues ------------------------------------------------------
    def make_shard_queue(self) -> MClockQueue:
        q = MClockQueue(classes=dict(self.registry.classes),
                        clock=self.clock,
                        resolver=self.registry.info_for)
        with self._lock:
            self._queues.append(q)
        return q

    # -- classification ----------------------------------------------------
    def classify_op(self, msg) -> Tuple[str, float]:
        """(queue class, cost units) for one MOSDOp.  Snaptrim ops are
        background tenants regardless of who sent them; everything
        else from a client entity is client work, tenant/pool
        resolved.  Cost charges payload bytes (write data in, read
        lengths out) so byte-heavy ops pay their true share."""
        from ceph_tpu_torch.osd import types as t_

        ops = getattr(msg, "ops", []) or []
        base = "client"
        if ops and all(o.op in (t_.OP_SNAPTRIM, t_.OP_SNAPTRIMPG)
                       for o in ops):
            base = "snaptrim"
        src = getattr(msg, "src", None)
        tenant = str(src) if src is not None and src.kind == "client" \
            else None
        pool = msg.pgid[0] if getattr(msg, "pgid", None) else None
        qcls = self.registry.resolve(base, tenant=tenant, pool=pool)
        nbytes = 0
        for o in ops:
            if o.is_write() and o.data is not None:
                # len() of a DeviceBuf/frame view is metadata, not a
                # host materialization
                nbytes += len(o.data) or o.length
            else:
                nbytes += o.length
        return qcls, max(1.0, nbytes / float(COST_UNIT_BYTES))

    # -- accounting --------------------------------------------------------
    def _bump(self, name: str, by: int = 1) -> None:
        if self.perf is not None:
            self.perf.add_u64_counter(name)  # idempotent on-demand
            self.perf.inc(name, by)

    def note_admit(self, qcls: str, cost: float = 1.0) -> None:
        """Enqueue-side accounting: per-class admitted counter + the
        client-pressure ring the recovery feedback reads."""
        self._bump(f"admitted_{_sane(qcls)}")
        if qcls == "client" or qcls.startswith(("client/", "pool/")):
            with self._lock:
                self._client_ops += 1
                ops = self._client_ops
            self._ring.push({"cl_ops": ops}, stamp=self.clock())

    def note_dequeue(self, qcls: str, phase: str, wait_s: float) -> None:
        """Dequeue-side accounting: phase counters + per-class wait
        histogram (microseconds, the per-tenant fairness evidence)."""
        self._bump(f"dequeue_{phase}" if phase in (
            PHASE_RESERVATION, PHASE_PRIORITY, PHASE_FALLBACK,
            PHASE_FIFO) else "dequeue_fifo")
        if self.perf is not None:
            hist = f"wait_us_{_sane(qcls)}"
            self.perf.add_histogram(hist)
            self.perf.hinc(hist, max(0.0, wait_s) * 1e6)

    # -- background tenants ------------------------------------------------
    def client_iops(self) -> float:
        """The feedback signal: client ops/s over the conf window,
        from the wired digest fn when present, else the local ring."""
        if self.client_rate_fn is not None:
            try:
                return float(self.client_rate_fn())
            except Exception:
                return 0.0
        window = float(self.conf.get("osd_qos_client_rate_window"))
        return self._ring.rate("cl_ops", window, now=self.clock())

    def recovery_window(self, base: int) -> int:
        """Effective recovery round width: the feedback controller.
        Idle clients -> widened (recovery takes the spare capacity);
        client pressure -> clamped to half; in between, the conf
        window as-is.  Always >= 1 — recovery must keep moving."""
        base = max(1, int(base))
        if not bool(self.conf.get("osd_recovery_feedback")):
            eff, state = base, "steady"
        else:
            rate = self.client_iops()
            idle = float(self.conf.get("osd_recovery_idle_client_iops"))
            busy = float(self.conf.get("osd_recovery_busy_client_iops"))
            if rate < idle:
                eff, state = base * int(
                    self.conf.get("osd_recovery_feedback_widen")), \
                    "widened"
            elif rate >= busy:
                eff, state = max(1, base // 2), "clamped"
            else:
                eff, state = base, "steady"
        with self._lock:
            self._recovery_state = state
            self._recovery_eff = eff
        if self.perf is not None:
            self.perf.add_u64_gauge("recovery_window_effective")
            self.perf.set("recovery_window_effective", eff)
        return eff

    def note_recovery_grant(self, n: int) -> None:
        with self._lock:
            self._recovery_granted += n
            state = self._recovery_state
            if state == "widened":
                self._recovery_widened += n
            elif state == "clamped":
                self._recovery_clamped += n
        if state == "widened":
            self._bump("recovery_widened", n)
        elif state == "clamped":
            self._bump("recovery_clamped", n)

    def background_pause(self, cls: str, n: float = 1.0) -> float:
        """Charge `n` background work units to `cls` and return the
        seconds the sweep should pause to stay inside the class limit
        (0.0 when unlimited).  The snaptrim/scrub grant discipline:
        the sweep loop owns the interruptible wait."""
        if cls not in ("snaptrim", "scrub"):
            return 0.0
        limit = self.registry.info_for(cls).limit
        with self._lock:
            b = self._bg_buckets.get(cls)
            if b is None or b.rate != limit:
                b = self._bg_buckets[cls] = _TokenBucket(
                    limit, clock=self.clock)
        return b.charge(n)

    # -- retune ------------------------------------------------------------
    def reload(self, spec: str) -> None:
        """Conf-observer entry (osd_qos_profiles changed): re-derive
        the registry and push the new triples into every live shard
        queue so in-queue tags keep order while future tags advance at
        the new rates."""
        self.registry.apply_spec(spec)
        with self._lock:
            queues = list(self._queues)
        for q in queues:
            for name in list(q.class_info()):
                q.set_class(name, self.registry.info_for(name))

    def set_class(self, target: str, reservation: float, weight: float,
                  limit: float) -> None:
        """Direct runtime retune (the mgr `qos set` fast path when no
        conf round-trip is wanted, and the test seam)."""
        info = ClientInfo(reservation=float(reservation),
                          weight=float(weight), limit=float(limit))
        self.registry.set_triple(target, info)
        qname = target
        if target.startswith("tenant:"):
            qname = f"client/{target.split(':', 1)[1]}"
        elif target.startswith("pool:"):
            qname = f"pool/{target.split(':', 1)[1]}"
        with self._lock:
            queues = list(self._queues)
        for q in queues:
            q.set_class(qname, info)

    # -- evidence ----------------------------------------------------------
    def status(self, msgr_perf=None) -> dict:
        """The `qos status` payload (admin socket, mgr QosModule,
        cephtop --qos, ceph_qos_* Prometheus gauges)."""
        depths: Dict[str, int] = {}
        with self._lock:
            queues = list(self._queues)
        for q in queues:
            for name, n in q.stats().items():
                depths[name] = depths.get(name, 0) + n
        perf = self.perf.dump() if self.perf is not None else {}
        classes: Dict[str, dict] = {}
        for name, triple in self.registry.dump().items():
            qname = name
            if name.startswith("tenant:"):
                qname = f"client/{name.split(':', 1)[1]}"
            elif name.startswith("pool:"):
                qname = f"pool/{name.split(':', 1)[1]}"
            row = dict(triple)
            row["depth"] = depths.get(qname, 0)
            row["admitted"] = perf.get(f"admitted_{_sane(qname)}", 0)
            wait = perf.get(f"wait_us_{_sane(qname)}")
            if isinstance(wait, dict):
                row["wait_us"] = hist_summary(wait)
            classes[name] = row
        # classes seen only at runtime (tenants without a profile
        # never mint one, so depth rows for minted overrides only)
        for qname, n in depths.items():
            key = qname
            if qname.startswith("client/"):
                key = f"tenant:{qname.split('/', 1)[1]}"
            elif qname.startswith("pool/"):
                key = f"pool:{qname.split('/', 1)[1]}"
            if key not in classes:
                classes[key] = {"depth": n}
        with self._lock:
            recovery = {
                "state": self._recovery_state,
                "effective_window": self._recovery_eff,
                "granted": self._recovery_granted,
                "widened": self._recovery_widened,
                "clamped": self._recovery_clamped,
            }
        recovery["client_iops"] = round(self.client_iops(), 2)
        out = {
            "scheduler": self.mode,
            "classes": classes,
            "dequeue_phases": {
                p: perf.get(f"dequeue_{p}", 0)
                for p in (PHASE_RESERVATION, PHASE_PRIORITY,
                          PHASE_FALLBACK, PHASE_FIFO)},
            "recovery": recovery,
        }
        if msgr_perf is not None:
            d = msgr_perf.dump()
            stall = d.get("throttle_stall_us")
            out["throttle"] = {
                "message_cap": int(self.conf.get(
                    "osd_client_message_cap")),
                "size_cap": int(self.conf.get(
                    "osd_client_message_size_cap")),
                "stalls": d.get("throttle_stall", 0),
                "stall_us": (hist_summary(stall)
                             if isinstance(stall, dict) else None),
            }
        return out
