"""lockdep — runtime lock-order cycle detection.

Reference role: src/common/lockdep.cc + mutex_debug.h: every named
mutex acquisition records "held -> acquiring" order edges in a global
graph; an acquisition that would close a cycle (lock A held while
taking B, elsewhere B held while taking A) raises immediately with
both chains — deadlocks become deterministic test failures instead of
rare production hangs.

Zero-cost when disabled: `make_lock(name)` hands back a plain RLock
unless lockdep is enabled (the reference gates on the `lockdep` config
the same way).

Port of ``ceph_tpu/core/lockdep.py``, name for name.  The port has no
static lock graph yet, so :func:`edge_graph` and :func:`dump` export
the runtime graph for a later cross-check against one.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from typing import Dict, List, Optional, Set

_enabled = False
_graph_lock = threading.Lock()
# edges[a][b]: b was acquired while a was held (a precedes b)
_edges: Dict[str, Set[str]] = {}
# first-seen acquisition site per edge, captured on the cold path
# only (once per distinct edge): "file:line in func" innermost-first
_edge_sites: Dict[tuple, str] = {}
_local = threading.local()


class LockOrderError(RuntimeError):
    pass


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()


def _held() -> List[str]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _path(frm: str, to: str) -> Optional[List[str]]:
    """A recorded order path frm -> ... -> to, or None."""
    seen = {frm}
    stack = [(frm, [frm])]
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == to:
                return path + [to]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


_EMPTY: frozenset = frozenset()


def will_lock(name: str) -> None:
    held = _held()
    if not held:
        return
    _check_order(held, name)


def _check_order(held: List[str], name: str) -> None:
    """Validate held -> name order edges.  Steady state is LOCK-FREE:
    set membership reads are GIL-atomic and the edge graph only ever
    grows, so a present edge is proof this exact order was already
    validated, and a global mutex + BFS per acquisition would cost
    every armed acquisition."""
    g = _edges
    need = None
    for h in held:
        if h != name and name not in g.get(h, _EMPTY):
            if need is None:
                need = [h]
            else:
                need.append(h)
    if need is None:
        return
    with _graph_lock:
        for h in need:
            if name in g.get(h, _EMPTY):
                continue  # another thread validated it meanwhile
            # adding h -> name; a recorded name -> ... -> h closes a cycle
            cycle = _path(name, h)
            if cycle is not None:
                raise LockOrderError(
                    f"lock order violation: acquiring {name!r} while "
                    f"holding {h!r}, but the reverse order "
                    f"{' -> '.join(cycle)} was recorded earlier"
                )
            g.setdefault(h, set()).add(name)
            _edge_sites[(h, name)] = _acquire_site()


def _acquire_site() -> str:
    """The innermost non-lockdep frame of the current acquisition —
    cold path only (runs once per distinct edge)."""
    here = os.path.abspath(__file__)
    for fr in reversed(traceback.extract_stack()):
        if os.path.abspath(fr.filename) != here:
            return f"{fr.filename}:{fr.lineno} in {fr.name}"
    return "<unknown>"


def locked(name: str) -> None:
    _held().append(name)


def unlocked(name: str) -> None:
    held = _held()
    if name in held:
        held.reverse()
        held.remove(name)
        held.reverse()


class DMutex:
    """Lock-order-checked re-entrant mutex (reference mutex_debug).

    Re-entrancy is judged against THIS thread's hold depth (a
    thread-local), never a shared counter — a contended acquisition
    (another thread holds the lock) is exactly the case the order
    check exists for."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.RLock()

    def _my_depth(self) -> Dict[int, int]:
        try:
            return _local.depth
        except AttributeError:
            _local.depth = {}
            return _local.depth

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # hand-flattened hot path: this wrapper runs on every named
        # lock in the system for the whole lockdep-armed test suite
        try:
            depths = _local.depth
        except AttributeError:
            depths = _local.depth = {}
        k = id(self)
        mine = depths.get(k, 0)
        first = mine == 0
        if first and _enabled:
            try:
                held = _local.stack
            except AttributeError:
                held = _local.stack = []
            if held:
                _check_order(held, self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            depths[k] = mine + 1
            if first and _enabled:
                _local.stack.append(self.name)
        return got

    def release(self) -> None:
        try:
            depths = _local.depth
        except AttributeError:
            depths = _local.depth = {}
        k = id(self)
        mine = depths.get(k, 1) - 1
        if mine <= 0:
            depths.pop(k, None)
            if _enabled:
                stack = getattr(_local, "stack", None)
                if stack:
                    name = self.name
                    for i in range(len(stack) - 1, -1, -1):
                        if stack[i] == name:
                            del stack[i]
                            break
        else:
            depths[k] = mine
        self._lock.release()

    # exactly like CPython's C lock objects: __enter__ IS acquire
    # (returns True, not self — nobody binds `with lock as x`), saving
    # a frame per with-block on the hottest wrapper in the suite
    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # -- threading.Condition protocol -------------------------------------
    # Condition(make_lock(...)) must behave exactly like
    # Condition(RLock()): delegate the save/restore hooks to the inner
    # RLock and keep our depth/held bookkeeping consistent across the
    # wait window.  No order check on re-acquire: the wakeup restores
    # an ordering that was already validated when the lock was first
    # taken.

    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        depths = self._my_depth()
        mine = depths.pop(id(self), 0)
        if _enabled and mine:
            unlocked(self.name)
        return (self._lock._release_save(), mine)

    def _acquire_restore(self, saved) -> None:
        state, mine = saved
        self._lock._acquire_restore(state)
        if mine:
            self._my_depth()[id(self)] = mine
            if _enabled:
                locked(self.name)


def make_lock(name: str):
    """A named checked mutex when lockdep is on, a bare RLock when off
    (the zero-overhead production default)."""
    if _enabled:
        return DMutex(name)
    return threading.RLock()


# -- graph export (for a static/runtime cross-check) ----------------------

def edge_graph() -> Dict[str, Dict[str, str]]:
    """Snapshot of the runtime-observed order graph:
    ``{held: {acquired: first_seen_site}}``.  Each edge carries the
    acquisition site recorded the FIRST time that order was seen —
    when a static lock model misses an edge, the site names the call
    path it failed to model."""
    with _graph_lock:
        return {a: {b: _edge_sites.get((a, b), "<unknown>")
                    for b in sorted(bs)}
                for a, bs in sorted(_edges.items())}


def dump(path: str) -> None:
    """Write the observed graph as JSON (the CEPH_TPU_LOCKDEP_DUMP
    hook writes this shape)."""
    payload = {"enabled": _enabled, "edges": edge_graph()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)


_DUMP_ENV = "CEPH_TPU_LOCKDEP_DUMP"
if os.environ.get(_DUMP_ENV):
    import atexit

    atexit.register(lambda: dump(os.environ[_DUMP_ENV]))

# arm from the environment so a run can record edges without arming
# in code: CEPH_TPU_LOCKDEP=1 (with CEPH_TPU_LOCKDEP_DUMP=<path>) dumps
# a live graph
if os.environ.get("CEPH_TPU_LOCKDEP") == "1":
    enable(True)
