"""Crash-dump capture + archive.

Reference roles: the crash metadata writer (src/global/signal_handler.cc
writes a backtrace + recent log ring on fatal signals; the ceph-crash
agent and the mgr crash module, src/pybind/mgr/crash/module.py, archive
and list them).  Here `CrashArchive.record()` captures a Python
exception — backtrace, entity, version, the log ring tail, and a
DEVICE section (queue depth, staging occupancy, the in-flight batch,
live and last compiles, storms, the kernel build and launches — see
gpu.devwatch.device_state) — as a JSON
crash report in a spool directory; `install()` hooks
`threading.excepthook` AND `sys.excepthook` so an unhandled daemon
thread OR main-thread death is archived automatically, and registers
the archive for asyncio event-loop deaths (messengers wire their
loops through :func:`install_loop_handler`); `ls`/`info` serve the
mgr `crash ls` commands.

Port of ``ceph_tpu/core/crash.py``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

# archives whose install() is live: asyncio loop handlers (wired per
# loop by install_loop_handler) record into every one of these — the
# loop exists before any archive does, so the binding is by lookup,
# not by reference
_INSTALLED: List["CrashArchive"] = []


class CrashArchive:
    def __init__(self, path: str, entity: str = "",
                 log=None, device_state_cb: Optional[Callable] = None
                 ) -> None:
        self.path = path
        self.entity = entity
        self.log = log
        # device-state provider for the crash report's device section;
        # default: the process-wide DeviceWatch snapshot (a wedged
        # device worker leaves its in-flight batch + last compiles in
        # the corpse).  Pass a callable to override (tests).
        self.device_state_cb = device_state_cb
        self._lock = threading.Lock()
        self._installed_hook = None
        self._installed_sys_hook = None
        self._prev_hook = None
        self._prev_sys_hook = None
        os.makedirs(path, exist_ok=True)

    # -- capture ----------------------------------------------------------
    def _device_section(self) -> Optional[Dict[str, object]]:
        cb = self.device_state_cb
        if cb is None:
            try:
                from ceph_tpu_torch.gpu.devwatch import watch

                cb = watch().device_state
            except Exception:  # pragma: no cover — torn interpreter
                return None
        try:
            return cb()
        except Exception as e:  # the device snapshot must never
            return {"error": repr(e)}  # prevent the crash report itself

    def record(self, exc: BaseException,
               entity: Optional[str] = None) -> str:
        """Archive one crash; returns the crash id."""
        stamp = time.time()
        device = self._device_section()
        with self._lock:
            crash_id = (time.strftime("%Y-%m-%dT%H:%M:%S",
                                      time.gmtime(stamp))
                        + f".{int(stamp * 1e6) % 1_000_000:06d}")
            report = {
                "crash_id": crash_id,
                "timestamp": stamp,
                "entity_name": entity or self.entity,
                "exception": repr(exc),
                "backtrace": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
                "recent_events": (self.log.dump_recent(200)
                                  if self.log is not None else []),
            }
            if device is not None:
                report["device"] = device
            with open(os.path.join(self.path, crash_id + ".json"),
                      "w") as f:
                json.dump(report, f, indent=1)
        return crash_id

    def install(self) -> None:
        """Hook the process's unhandled-exception surfaces: a daemon
        THREAD dying (threading.excepthook), the MAIN thread dying
        (sys.excepthook), and — via install_loop_handler, which
        messengers call on their event loops — an asyncio callback
        dying, all leave a crash report behind (the fatal
        signal-handler role; before this, only daemon threads did)."""
        prev = threading.excepthook

        def hook(args):
            if args.exc_value is not None:
                try:
                    self.record(args.exc_value)
                except Exception:
                    pass
            prev(args)

        self._installed_hook = hook
        self._prev_hook = prev
        threading.excepthook = hook

        prev_sys = sys.excepthook

        def sys_hook(exc_type, exc, tb):
            if exc is not None:
                try:
                    self.record(exc)
                # hook of last
                # resort: a failing archive write must never mask the
                # original fatal exception being reported below
                except Exception:
                    pass
            prev_sys(exc_type, exc, tb)

        self._installed_sys_hook = sys_hook
        self._prev_sys_hook = prev_sys
        sys.excepthook = sys_hook
        if self not in _INSTALLED:
            _INSTALLED.append(self)

    def uninstall(self) -> None:
        # restore the hook install() CHAINED, not the interpreter
        # default — a harness's own excepthook (pytest plugin, error
        # reporter) installed before us must survive our teardown
        if (self._installed_hook is not None
                and threading.excepthook is self._installed_hook):
            threading.excepthook = (self._prev_hook
                                    or threading.__excepthook__)
        self._installed_hook = None
        self._prev_hook = None
        if (self._installed_sys_hook is not None
                and sys.excepthook is self._installed_sys_hook):
            sys.excepthook = self._prev_sys_hook or sys.__excepthook__
        self._installed_sys_hook = None
        self._prev_sys_hook = None
        if self in _INSTALLED:
            _INSTALLED.remove(self)

    # -- query (mgr crash module commands) --------------------------------
    def ls(self) -> List[Dict[str, object]]:
        out = []
        for fn in sorted(os.listdir(self.path)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.path, fn)) as f:
                    r = json.load(f)
                out.append({"crash_id": r["crash_id"],
                            "entity_name": r.get("entity_name", ""),
                            "timestamp": r.get("timestamp", 0)})
            except (OSError, ValueError):
                continue
        return out

    def info(self, crash_id: str) -> Optional[Dict[str, object]]:
        p = os.path.join(self.path, crash_id + ".json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def prune(self, keep: int = 100) -> None:
        files = sorted(fn for fn in os.listdir(self.path)
                       if fn.endswith(".json"))
        for fn in files[:-keep] if keep else files:
            try:
                os.unlink(os.path.join(self.path, fn))
            except OSError:
                pass


def install_loop_handler(loop) -> None:
    """Wire an asyncio event loop's exception handler into the crash
    machinery: an exception escaping a loop callback/task is recorded
    into every installed archive, then handed to the loop's default
    handler (the log line survives unchanged).  Messengers call this
    on the loop they own, so an event-loop death leaves a crash
    report too."""
    def handler(lp, context):
        exc = context.get("exception")
        if exc is not None:
            for arch in list(_INSTALLED):
                try:
                    arch.record(exc)
                # handler of last
                # resort: one torn archive must not stop the others,
                # and the default handler below still logs the death
                except Exception:
                    pass
        lp.default_exception_handler(context)

    loop.set_exception_handler(handler)
