"""failpoint — deterministic fault/sync injection at named hazard points.

The reference grew `ceph_abort`/failpoint-style debug-inject hooks
(`filestore_debug_inject_read_err`, `osd_debug_inject_failure_on_*`,
the common/fault_injector.h FaultInjector) exactly where distributed
races live: commit-ack delivery, peering arbitration, recovery landing,
journal sync.  This module is that facility for the whole stack: a
process-wide registry of **named points** that are a dict-miss/None
check when disarmed and a schedulable action when armed — so a thrash
race observed once under load becomes a barrier schedule that replays
on a quiet box in milliseconds.

Usage at an instrumented site::

    from ceph_tpu_torch.core import failpoint as fp
    fp.failpoint("pg.rollback.entry", oid=en.oid)          # plain hook
    if fp.enabled("msg.frame.deliver"):                    # hot path:
        if fp.failpoint("msg.frame.deliver",               # no kwargs
                        mtype=type(msg).__name__) is fp.DROP:   # built
            return                                         # disarmed

Sites that honor the ``DROP`` verdict model *message/record loss* (the
operation silently does not happen); the two ``store.corrupt_*`` sites
honor ``CORRUPT`` (the store serves seeded bit-flipped bytes — silent
at-rest corruption); all other actions are effects the point
raises/blocks on directly.

Arming::

    fp.arm("store.commit_batch.sync", fp.sleep_ms(50), prob=0.1)
    fp.arm("pg.commit_note.persist", fp.DROP_ACTION, count=1,
           match={"osd": "2"})
    fp.arm("pg.commit_note.broadcast", fp.barrier("hold-note"))

or declaratively (env ``CEPH_TPU_FAILPOINTS`` / conf
``failpoint_inject``), comma-separated::

    name=action[:modifier[:modifier...]]
    actions:    sleep(ms) | error[(ExcName)] | kill | drop |
                corrupt | barrier(token)
    modifiers:  once | count(n) | prob(p) | match(key=substr)

``prob`` draws from a per-point RNG seeded by ``(seed(), name)``, so a
thrash seed fully determines which points fire at which hit counts —
the seeded deterministic scheduler.  ``barrier(token)`` parks the
hitting thread until the test script calls :func:`release` (or
:func:`abort`); :func:`wait_hit` lets the script rendezvous with the
parked thread first.  Every armed name must exist in :data:`POINTS` —
the same table the reference's ``failpoint-name-registry`` lint check
holds call sites to, so a typo is impossible to arm.

Port of ``ceph_tpu/core/failpoint.py``: the same points, actions,
modifiers, DSL, barriers and seeded per-point streams.  The port's
sites so far: ``queue.batch.dispatch`` (``gpu/queue.py``),
``msg.frame.deliver`` (``msg/messenger.py``) and the store's
``store.commit_batch.sync``, ``store.corrupt_chunk`` and
``store.corrupt_xattr`` (``store/objectstore.py``).  The
``error(EIO)`` action raises the port's ``store.objectstore.StoreError``,
imported when the action is parsed (``objectstore`` imports this
module).
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ceph_tpu_torch.core.lockdep import make_lock

# ---------------------------------------------------------------------------
# Declaration table — the single source of truth for point names.
# Instrumented call sites and arming both validate against it.
# ---------------------------------------------------------------------------

POINTS: Dict[str, str] = {
    # -- commit-ack delivery & committed_to watermark (osd/pg.py, backend)
    "pg.commit.client_reply":
        "primary, before an acked write's client reply is fired",
    "pg.commit_note.broadcast":
        "primary, before the eager committed_to note broadcast "
        "(degraded-commit durable-ack gate)",
    "pg.commit_note.persist":
        "shard, before merging+persisting a received commit note "
        "(DROP models the in-flight note dying with the primary)",
    "pg.commit_note.ack":
        "shard, before answering a gated commit note (DROP models a "
        "lost ack frame)",
    "backend.subwrite.fanout":
        "primary, before each peer's sub-write(vec) send "
        "(DROP models a sub-write lost to a kill boundary)",
    "backend.commit.ack":
        "primary, as a peer's commit ack is accounted",
    # -- divergent-head arbitration & rewind (osd/pg.py, osd/pglog.py)
    "pg.resolve_divergent":
        "primary, before divergent-head arbitration picks an "
        "authoritative version",
    "pg.rollback.entry":
        "any member, before one divergent entry's rollback record "
        "is applied",
    "pglog.rewind":
        "inside PGLog.rewind_to once divergent entries are dropped",
    # -- recovery landing (osd/recovery.py)
    "recovery.store_recovered":
        "primary, before a rebuilt object's shard txn (with its _av "
        "stamp) is queued",
    # -- staging / device batch (gpu/staging.py, gpu/queue.py)
    "staging.seal":
        "write fan-out, before a staged payload's slot is sealed back "
        "to the pool",
    "queue.batch.dispatch":
        "stripe-batch queue, before a coalesced device batch dispatch",
    # -- messenger & store (msg/messenger.py, store/*.py)
    "msg.frame.deliver":
        "messenger, before a decoded frame reaches dispatch (DROP "
        "models in-flight frame loss at a kill boundary)",
    "store.commit_batch.sync":
        "commit pipeline, between batch swap and the batched sync "
        "(the WAL-appended-nothing-synced kill window)",
    "store.filestore.read":
        "FileStore.read entry (error(EIO) is the "
        "filestore_debug_inject_read_err hook)",
    # -- silent corruption (every store's read boundary, objectstore.py)
    "store.corrupt_chunk":
        "any store's read() return — CORRUPT verdict bit-flips the "
        "served bytes (seeded silent at-rest corruption; scope with "
        "match(oid=/coll=/shard=) so only the targeted shards rot)",
    "store.corrupt_xattr":
        "any store's getattr() return — CORRUPT verdict bit-flips the "
        "served attr value (silent metadata corruption)",
    # -- scrub engine (osd/scrub.py)
    "scrub.chunk":
        "scrub engine, before each deep-scrub chunk is verified (the "
        "kill/preempt/resume seam: a barrier here parks the scrub "
        "with its cursor persisted)",
}

DROP = object()          # verdict: the call site skips the operation
DROP_ACTION = "drop"     # arm(name, DROP_ACTION) => hits return DROP
# verdict: the call site serves CORRUPTED bytes — only the two
# store.corrupt_* points honor it, via corrupt_bytes() below
CORRUPT = object()
CORRUPT_ACTION = "corrupt"


def corrupt_bytes(data, key: str) -> bytes:
    """Deterministic seeded bit-flips for the CORRUPT verdict: flip
    positions come from (seed(), key) — one bit per 512 bytes, at
    least one — so a chaos seed fully determines WHERE the rot lands
    and a replay reproduces the same damage byte for byte."""
    if not data:
        return bytes(data)
    rng = random.Random(f"{_seed}:corrupt:{key}")
    buf = bytearray(data)
    for _ in range(max(1, len(buf) // 512)):
        i = rng.randrange(len(buf))
        buf[i] ^= 1 << rng.randrange(8)
    return bytes(buf)


class FailpointError(RuntimeError):
    """Default exception for error-action points."""


class KilledAtFailpoint(BaseException):
    """Raised by the `kill` action with no kill hook installed; derives
    from BaseException so ordinary `except Exception` recovery code
    cannot swallow a simulated death."""


class FailpointAborted(RuntimeError):
    """Raised in threads parked at a barrier when the schedule aborts
    the token instead of releasing it."""


_ERRORS = {
    "FailpointError": FailpointError,
    "OSError": OSError,
    "IOError": OSError,
    "EIO": None,  # resolved lazily to StoreError (import cycle)
    "RuntimeError": RuntimeError,
    "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError,
}


def _resolve_error(name: str):
    if name == "EIO":
        from ceph_tpu_torch.store.objectstore import StoreError

        return StoreError
    exc = _ERRORS.get(name)
    if exc is None:
        raise ValueError(f"failpoint: unknown error class {name!r}")
    return exc


# ---------------------------------------------------------------------------
# Barriers — the no-sleep deterministic scheduler primitive
# ---------------------------------------------------------------------------


class _Barrier:
    def __init__(self, token: str) -> None:
        self.token = token
        self.cond = threading.Condition(make_lock(f"failpoint.barrier.{token}"))
        self.arrived = 0       # total threads that ever hit
        self.waiting = 0       # threads currently parked
        self.released = False
        self.aborted = False

    def park(self) -> None:
        with self.cond:
            self.arrived += 1
            self.waiting += 1
            self.cond.notify_all()  # wake wait_hit observers
            try:
                while not (self.released or self.aborted):
                    self.cond.wait(0.05)
            finally:
                self.waiting -= 1
                self.cond.notify_all()
            if self.aborted:
                raise FailpointAborted(self.token)


_barrier_lock = make_lock("failpoint.barriers")
_barriers: Dict[str, _Barrier] = {}


def _barrier_of(token: str) -> _Barrier:
    with _barrier_lock:
        b = _barriers.get(token)
        if b is None:
            b = _barriers[token] = _Barrier(token)
        return b


def wait_hit(token: str, timeout: float = 10.0, n: int = 1) -> bool:
    """Block until at least `n` threads have ARRIVED at barrier
    `token` (parked or already through); the test-script half of a
    rendezvous.  Returns False on timeout."""
    b = _barrier_of(token)
    deadline = time.monotonic() + timeout
    with b.cond:
        while b.arrived < n:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            b.cond.wait(min(left, 0.05))
    return True


def release(token: str) -> None:
    """Open barrier `token` permanently: parked threads resume, later
    hits pass straight through."""
    b = _barrier_of(token)
    with b.cond:
        b.released = True
        b.cond.notify_all()


def abort(token: str) -> None:
    """Raise FailpointAborted in every thread parked at `token` (and
    any later arrival) — models the parked operation dying."""
    b = _barrier_of(token)
    with b.cond:
        b.aborted = True
        b.cond.notify_all()


# ---------------------------------------------------------------------------
# Actions (arm() accepts these, a callable, or a DSL string)
# ---------------------------------------------------------------------------


def sleep_ms(ms: float) -> Callable[[dict], None]:
    def act(_ctx: dict) -> None:
        time.sleep(ms / 1000.0)

    act.__name__ = f"sleep({ms})"
    return act


def error(exc=FailpointError) -> Callable[[dict], None]:
    """Raise ``exc`` (a class or an instance) at the point."""
    def act(ctx: dict) -> None:
        if isinstance(exc, BaseException):
            raise exc
        raise exc(f"injected at failpoint ({ctx})")

    act.__name__ = "error"
    return act


def barrier(token: str) -> Callable[[dict], None]:
    def act(_ctx: dict) -> None:
        _barrier_of(token).park()

    act.__name__ = f"barrier({token})"
    return act


_kill_hook: Optional[Callable[[str, dict], None]] = None


def set_kill_hook(fn: Optional[Callable[[str, dict], None]]) -> None:
    """Install the process's `kill` action (a MiniCluster harness kills
    the hitting daemon); None restores the default, which raises
    KilledAtFailpoint through the hitting thread."""
    global _kill_hook
    _kill_hook = fn


def kill() -> Callable[[dict], None]:
    def act(ctx: dict) -> None:
        hook = _kill_hook
        if hook is not None:
            hook(ctx.get("_name", "?"), ctx)
            return
        raise KilledAtFailpoint(ctx.get("_name", "?"))

    act.__name__ = "kill"
    return act


# ---------------------------------------------------------------------------
# The registry core
# ---------------------------------------------------------------------------

_seed = 0


class _Point:
    __slots__ = ("name", "action", "count", "prob", "match", "rng",
                 "hits", "fired", "lock")

    def __init__(self, name: str, action, count: Optional[int],
                 prob: Optional[float],
                 match: Optional[Dict[str, str]]) -> None:
        self.name = name
        self.action = action
        self.count = count          # fire at most n times, then disarm
        self.prob = prob
        self.match = match or None
        # per-point deterministic stream: (seed, name) fixes the whole
        # firing pattern independent of arming order
        self.rng = random.Random(f"{_seed}:{name}")
        self.hits = 0
        self.fired = 0
        self.lock = make_lock(f"failpoint.point.{name}")

    def hit(self, ctx: dict):
        with self.lock:
            self.hits += 1
            if self.match:
                for k, want in self.match.items():
                    if want not in str(ctx.get(k, "")):
                        _note_history(self.name, True, False)
                        return None
            if self.prob is not None and self.rng.random() >= self.prob:
                _note_history(self.name, True, False)
                return None
            if self.count is not None and self.fired >= self.count:
                _note_history(self.name, True, False)
                return None
            self.fired += 1
            exhausted = (self.count is not None
                         and self.fired >= self.count)
        _note_history(self.name, True, True)
        if exhausted:
            disarm(self.name, _only_if_is=self)
        if self.action == DROP_ACTION:
            return DROP
        if self.action == CORRUPT_ACTION:
            return CORRUPT
        ctx = dict(ctx)
        ctx["_name"] = self.name
        self.action(ctx)
        return None


_lock = make_lock("failpoint.registry")
# None <=> nothing armed anywhere: failpoint()'s whole disarmed cost is
# this one load + None check (plus the caller's arg packing — hot sites
# guard with enabled() so they pack nothing while disarmed)
_armed: Optional[Dict[str, _Point]] = None
# cumulative (hits, fired) per name, surviving disarm (a count(n)
# point disarms itself after its last firing — observability must not
# vanish with it); reset by disarm_all()
_history: Dict[str, List[int]] = {}


def _note_history(name: str, hit: bool, fired_: bool) -> None:
    with _lock:
        row = _history.setdefault(name, [0, 0])
        if hit:
            row[0] += 1
        if fired_:
            row[1] += 1


def enabled(name: str) -> bool:
    table = _armed
    return table is not None and name in table


def failpoint(name: str, **ctx):
    """The instrumented-site hook: no-op (None) while `name` is
    disarmed; otherwise runs the armed action and returns its verdict
    (DROP, or None after sleep/barrier/raise)."""
    table = _armed
    if table is None:
        return None
    p = table.get(name)
    if p is None:
        return None
    return p.hit(ctx)


def arm(name: str, action, *, once: bool = False,
        count: Optional[int] = None, prob: Optional[float] = None,
        match: Optional[Dict[str, str]] = None) -> None:
    """Arm `name` with `action` (a callable(ctx), DROP_ACTION, or a DSL
    string like "sleep(5)").  Unknown names are an error — the registry
    table is the contract."""
    global _armed
    if name not in POINTS:
        raise KeyError(f"failpoint {name!r} is not declared in "
                       f"failpoint.POINTS")
    if isinstance(action, str) and action not in (DROP_ACTION,
                                                  CORRUPT_ACTION):
        action = _parse_action(action)
    if once:
        count = 1
    p = _Point(name, action, count, prob, match)
    with _lock:
        table = dict(_armed or {})
        table[name] = p
        _armed = table


def disarm(name: str, _only_if_is: Optional[_Point] = None) -> None:
    global _armed
    with _lock:
        if _armed is None:
            return
        if _only_if_is is not None and _armed.get(name) is not _only_if_is:
            return  # re-armed since: the newer arming wins
        table = dict(_armed)
        table.pop(name, None)
        _armed = table or None


def disarm_all() -> None:
    global _armed
    with _lock:
        _armed = None
        _history.clear()  # hits()/fired() promise a reset here
    with _barrier_lock:
        # release any parked threads so tests can't leak wedged daemons
        for b in _barriers.values():
            with b.cond:
                if not b.aborted:
                    b.released = True
                b.cond.notify_all()
        _barriers.clear()


def hits(name: str) -> int:
    """Cumulative times `name` was hit while armed (match-filtered
    hits count; survives the point's self-disarm) — test
    observability.  Reset by disarm_all()."""
    with _lock:
        return _history.get(name, [0, 0])[0]


def fired(name: str) -> int:
    """Cumulative times `name`'s action actually ran (survives
    self-disarm).  Reset by disarm_all()."""
    with _lock:
        return _history.get(name, [0, 0])[1]


def seed(value: int) -> None:
    """Fix the deterministic scheduler seed: every point armed AFTER
    this draws its prob() stream from (value, name), so a thrash seed
    fully determines which points fire."""
    global _seed
    _seed = int(value)


# ---------------------------------------------------------------------------
# DSL parsing (env CEPH_TPU_FAILPOINTS / conf failpoint_inject)
# ---------------------------------------------------------------------------

_ACT_RE = re.compile(r"^(\w+)(?:\(([^)]*)\))?$")


def _parse_action(spec: str):
    mm = _ACT_RE.match(spec.strip())
    if not mm:
        raise ValueError(f"failpoint: bad action {spec!r}")
    kind, arg = mm.group(1), mm.group(2)
    if kind == "sleep":
        return sleep_ms(float(arg))
    if kind == "error":
        return error(_resolve_error(arg) if arg else FailpointError)
    if kind == "kill":
        return kill()
    if kind == "drop":
        return DROP_ACTION
    if kind == "corrupt":
        return CORRUPT_ACTION
    if kind == "barrier":
        if not arg:
            raise ValueError("failpoint: barrier needs a token")
        return barrier(arg)
    raise ValueError(f"failpoint: unknown action {kind!r}")


def arm_from_spec(spec: str) -> List[str]:
    """Parse and arm a DSL spec string (see module docstring); returns
    the armed names.  Empty/blank spec is a no-op."""
    armed: List[str] = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"failpoint: bad spec {part!r}")
        name, rhs = part.split("=", 1)
        name = name.strip()
        fields = rhs.split(":")
        action = fields[0]
        kw: Dict[str, Any] = {}
        for mod in fields[1:]:
            mmod = _ACT_RE.match(mod.strip())
            if not mmod:
                raise ValueError(f"failpoint: bad modifier {mod!r}")
            mk, marg = mmod.group(1), mmod.group(2)
            if mk == "once":
                kw["once"] = True
            elif mk == "count":
                kw["count"] = int(marg)
            elif mk == "prob":
                kw["prob"] = float(marg)
            elif mk == "match":
                k, _, v = (marg or "").partition("=")
                kw.setdefault("match", {})[k.strip()] = v.strip()
            else:
                raise ValueError(f"failpoint: unknown modifier {mk!r}")
        act = action.strip()
        arm(name, act if act in (DROP_ACTION, CORRUPT_ACTION)
            else _parse_action(act), **kw)
        armed.append(name)
    return armed


def _arm_from_env() -> None:
    spec = os.environ.get("CEPH_TPU_FAILPOINTS", "")
    sd = os.environ.get("CEPH_TPU_FAILPOINT_SEED", "")
    if sd:
        seed(int(sd, 0))
    if spec:
        arm_from_spec(spec)


_arm_from_env()
