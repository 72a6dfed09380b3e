"""cls — in-OSD object classes ("stored procedures").

Reference role: src/objclass/ + src/osd/ClassHandler.cc and the
src/cls/ plugin family: clients invoke `class.method` ON an object via
OP_CALL and the method executes atomically inside the PG write path
with direct access to the object's data/xattrs/omap.  RBD and RGW are
built on these in the reference; here the registry hosts the same
extension point with python callables (third parties register at
runtime) plus the lock / refcount / version built-ins.

Method signature: fn(ctx: MethodContext, indata: bytes) -> bytes
(raise ClsError(errno) for failures).  WR-flagged methods run in the
PG's serialized write pipeline and their mutations replicate like any
write; RD methods run on the read path.

Port of ``ceph_tpu/osd/cls.py``, name for name: the same methods with
the same out bytes, errnos and mutations of the ``ObjectState``.  The
port's ``ClassHandler`` is its own singleton, never the reference's, so
a class registered in one package is not seen by the other.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, Optional, Tuple

CLS_RD = 1
CLS_WR = 2

EBUSY, ENOENT, EINVAL, ENOTSUP = -16, -2, -22, -95


class ClsError(Exception):
    def __init__(self, errno: int, what: str = "") -> None:
        super().__init__(what or f"cls error {errno}")
        self.errno = errno


class MethodContext:
    """The object view a method mutates (reference cls_method_context_t
    over the op's ObjectState)."""

    def __init__(self, state, exists: bool, writable: bool) -> None:
        self.state = state
        self.exists = exists
        self.writable = writable
        self.delete_object = False

    # -- reads ------------------------------------------------------------
    def read(self, off: int = 0, length: int = 0) -> bytes:
        if not self.exists:
            raise ClsError(ENOENT)
        end = off + length if length else len(self.state.data)
        return self.state.data[off:end]

    def getxattr(self, name: str) -> bytes:
        if not self.exists or name not in self.state.xattrs:
            raise ClsError(ENOENT)
        return self.state.xattrs[name]

    def omap_get(self, keys=None) -> Dict[str, bytes]:
        if not self.exists:
            raise ClsError(ENOENT)
        if keys:
            return {k: self.state.omap[k] for k in keys
                    if k in self.state.omap}
        return dict(self.state.omap)

    # -- writes -----------------------------------------------------------
    def _need_write(self) -> None:
        if not self.writable:
            raise ClsError(ENOTSUP, "WR method invoked on the read path")

    def write_full(self, data: bytes) -> None:
        self._need_write()
        self.state.data = data
        self.exists = True

    def setxattr(self, name: str, value: bytes) -> None:
        self._need_write()
        self.state.xattrs[name] = value
        self.exists = True

    def rmxattr(self, name: str) -> None:
        self._need_write()
        self.state.xattrs.pop(name, None)

    def omap_set(self, kv: Dict[str, bytes]) -> None:
        self._need_write()
        self.state.omap.update(kv)
        self.exists = True

    def omap_rm(self, keys) -> None:
        self._need_write()
        for k in keys:
            self.state.omap.pop(k, None)

    def remove(self) -> None:
        self._need_write()
        self.delete_object = True


class ClassHandler:
    """name -> (flags, fn) registry (reference ClassHandler::open_class;
    python registration replaces dlopen)."""

    _instance: "ClassHandler | None" = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._methods: Dict[str, Tuple[int, Callable]] = {}
        _register_builtins(self)
        _register_extended_families(self)

    @classmethod
    def instance(cls) -> "ClassHandler":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register(self, cls_name: str, method: str, flags: int,
                 fn: Callable[[MethodContext, bytes], bytes]) -> None:
        self._methods[f"{cls_name}.{method}"] = (flags, fn)

    def get(self, full_name: str) -> Optional[Tuple[int, Callable]]:
        return self._methods.get(full_name)

    def is_write(self, full_name: str) -> bool:
        got = self._methods.get(full_name)
        return bool(got and got[0] & CLS_WR)

    def names(self):
        return sorted(self._methods)


# -- built-in classes (reference src/cls/{lock,refcount,version}) ----------

def _register_builtins(h: ClassHandler) -> None:
    # cls_lock: advisory object locks in an xattr
    def lock_lock(ctx: MethodContext, indata: bytes) -> bytes:
        req = json.loads(indata.decode() or "{}")
        name = req.get("name", "lock")
        owner = req.get("owner", "")
        ltype = req.get("type", "exclusive")
        key = f"lock.{name}"
        cur = None
        if ctx.exists and key in ctx.state.xattrs:
            cur = json.loads(ctx.state.xattrs[key].decode())
        if cur:
            if ltype == "shared" and cur["type"] == "shared":
                if owner not in cur["owners"]:
                    cur["owners"].append(owner)
                ctx.setxattr(key, json.dumps(cur).encode())
                return b""
            if cur["owners"] != [owner]:
                raise ClsError(EBUSY, f"lock {name} held")
        ctx.setxattr(key, json.dumps(
            {"type": ltype, "owners": [owner]}).encode())
        return b""

    def lock_unlock(ctx: MethodContext, indata: bytes) -> bytes:
        req = json.loads(indata.decode() or "{}")
        key = f"lock.{req.get('name', 'lock')}"
        owner = req.get("owner", "")
        try:
            cur = json.loads(ctx.getxattr(key).decode())
        except ClsError:
            raise ClsError(ENOENT, "not locked")
        if owner not in cur["owners"]:
            raise ClsError(EBUSY, "not the lock owner")
        cur["owners"].remove(owner)
        if cur["owners"]:
            ctx.setxattr(key, json.dumps(cur).encode())
        else:
            ctx.rmxattr(key)
        return b""

    def lock_info(ctx: MethodContext, indata: bytes) -> bytes:
        req = json.loads(indata.decode() or "{}")
        key = f"lock.{req.get('name', 'lock')}"
        return ctx.getxattr(key)

    h.register("lock", "lock", CLS_RD | CLS_WR, lock_lock)
    h.register("lock", "unlock", CLS_RD | CLS_WR, lock_unlock)
    h.register("lock", "get_info", CLS_RD, lock_info)

    # cls_refcount: reference counting with delete-on-zero
    def refcount_get(ctx: MethodContext, indata: bytes) -> bytes:
        tag = indata.decode() or "default"
        refs = set()
        if ctx.exists and "refcount" in ctx.state.xattrs:
            refs = set(json.loads(ctx.state.xattrs["refcount"].decode()))
        refs.add(tag)
        ctx.setxattr("refcount", json.dumps(sorted(refs)).encode())
        return b""

    def refcount_put(ctx: MethodContext, indata: bytes) -> bytes:
        tag = indata.decode() or "default"
        try:
            refs = set(json.loads(ctx.getxattr("refcount").decode()))
        except ClsError:
            raise ClsError(ENOENT, "no refs")
        refs.discard(tag)
        if refs:
            ctx.setxattr("refcount", json.dumps(sorted(refs)).encode())
        else:
            ctx.remove()  # last ref dropped: the object goes away
        return b""

    def refcount_read(ctx: MethodContext, indata: bytes) -> bytes:
        try:
            return ctx.getxattr("refcount")
        except ClsError:
            return b"[]"

    h.register("refcount", "get", CLS_RD | CLS_WR, refcount_get)
    h.register("refcount", "put", CLS_RD | CLS_WR, refcount_put)
    h.register("refcount", "read", CLS_RD, refcount_read)

    # cls_version: optimistic-concurrency object versions
    def version_set(ctx: MethodContext, indata: bytes) -> bytes:
        ctx.setxattr("cls_version", indata)
        return b""

    def version_get(ctx: MethodContext, indata: bytes) -> bytes:
        try:
            return ctx.getxattr("cls_version")
        except ClsError:
            return b"0"

    def version_check(ctx: MethodContext, indata: bytes) -> bytes:
        want = indata
        have = b"0"
        try:
            have = ctx.getxattr("cls_version")
        except ClsError:
            pass
        if have != want:
            raise ClsError(EINVAL, f"version {have!r} != {want!r}")
        return b""

    h.register("version", "set", CLS_RD | CLS_WR, version_set)
    h.register("version", "get", CLS_RD, version_get)
    h.register("version", "check", CLS_RD, version_check)

    # cls_counter: atomic monotonic allocators (snap ids, inode
    # numbers, ... — the mon-allocator role for pool-local sequences)
    def counter_alloc(ctx: MethodContext, indata: bytes) -> bytes:
        key = (indata.decode() or "seq")
        cur = int(ctx.omap_get([key]).get(key, b"0")) if ctx.exists else 0
        ctx.omap_set({key: str(cur + 1).encode()})
        return str(cur + 1).encode()

    def counter_get(ctx: MethodContext, indata: bytes) -> bytes:
        key = (indata.decode() or "seq")
        try:
            cur = (int(ctx.omap_get([key]).get(key, b"0"))
                   if ctx.exists else 0)
        except ValueError:
            raise ClsError(-22, f"counter {key!r} holds a non-number")
        return str(cur).encode()

    def counter_max(ctx: MethodContext, indata: bytes) -> bytes:
        # "key value": atomically raise the counter to value (monotonic
        # watermark — commit positions, applied-up-to markers).
        # Malformed input must surface as EINVAL, not an escaped
        # exception (which would leave the client op unanswered).
        try:
            key, val = indata.decode().split(" ", 1)
            want = int(val)
            cur = (int(ctx.omap_get([key]).get(key, b"0"))
                   if ctx.exists else 0)
        except (ValueError, UnicodeDecodeError):
            raise ClsError(-22, "counter.max wants 'key <int>'")
        new = max(cur, want)
        ctx.omap_set({key: str(new).encode()})
        return str(new).encode()

    h.register("counter", "alloc", CLS_RD | CLS_WR, counter_alloc)
    h.register("counter", "get", CLS_RD, counter_get)
    h.register("counter", "max", CLS_RD | CLS_WR, counter_max)


def _guard_input(fn):
    """Malformed client payloads surface as EINVAL, never as an escaped
    exception (the PG op path catches only ClsError; anything else
    leaves the client op unanswered)."""
    import functools

    @functools.wraps(fn)
    def wrapped(ctx, indata):
        try:
            return fn(ctx, indata)
        except ClsError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ClsError(EINVAL, f"bad input: {e!r}")

    return wrapped


def _register_extended_families(h: ClassHandler) -> None:
    """The remaining reference cls families this framework models
    (reference src/cls/: journal, numops, timeindex,
    otp — user/lua have no meaningful analog here)."""
    import json as _json
    import time as _time

    # cls_journal (reference src/cls/journal/): journal CLIENT
    # registration + per-client commit positions on the journal's
    # metadata object — the bookkeeping rbd-mirror peers use so a
    # journal knows how far every consumer has replayed (and what may
    # be trimmed)
    @_guard_input
    def journal_client_register(ctx: MethodContext, indata: bytes) -> bytes:
        req = _json.loads(indata.decode())
        key = f"jclient.{req['id']}"
        if ctx.exists and key in ctx.omap_get([key]):
            raise ClsError(-17, "client exists")
        ctx.omap_set({key: _json.dumps(
            {"id": req["id"], "commit": int(req.get("commit", 0)),
             "data": req.get("data", "")}).encode()})
        return b""

    @_guard_input
    def journal_client_unregister(ctx: MethodContext,
                                  indata: bytes) -> bytes:
        key = f"jclient.{indata.decode()}"
        if key not in ctx.omap_get([key]):
            raise ClsError(-2, "no such client")
        ctx.omap_rm([key])
        return b""

    @_guard_input
    def journal_client_commit(ctx: MethodContext, indata: bytes) -> bytes:
        req = _json.loads(indata.decode())
        key = f"jclient.{req['id']}"
        got = ctx.omap_get([key])
        if key not in got:
            raise ClsError(-2, "no such client")
        cl = _json.loads(got[key].decode())
        # commit positions are monotonic watermarks
        cl["commit"] = max(int(cl.get("commit", 0)), int(req["commit"]))
        ctx.omap_set({key: _json.dumps(cl).encode()})
        return str(cl["commit"]).encode()

    @_guard_input
    def journal_client_list(ctx: MethodContext, indata: bytes) -> bytes:
        if not ctx.exists:
            return b"[]"
        out = [_json.loads(v.decode())
               for k, v in sorted(ctx.omap_get().items())
               if k.startswith("jclient.")]
        return _json.dumps(out).encode()

    @_guard_input
    def journal_get_client(ctx: MethodContext, indata: bytes) -> bytes:
        key = f"jclient.{indata.decode()}"
        got = ctx.omap_get([key])
        if key not in got:
            raise ClsError(-2, "no such client")
        return got[key]

    h.register("journal", "client_register", CLS_RD | CLS_WR,
               journal_client_register)
    h.register("journal", "client_unregister", CLS_RD | CLS_WR,
               journal_client_unregister)
    h.register("journal", "client_commit", CLS_RD | CLS_WR,
               journal_client_commit)
    h.register("journal", "client_list", CLS_RD, journal_client_list)
    h.register("journal", "get_client", CLS_RD, journal_get_client)

    # cls_numops (reference src/cls/numops/): atomic arithmetic on a
    # numeric omap value; non-numeric stored values are EINVAL exactly
    # like the reference's strtod guard
    def _numops(ctx: MethodContext, indata: bytes, op: str) -> bytes:
        try:
            key, val = indata.decode().split(" ", 1)
            delta = float(val)
        except (ValueError, UnicodeDecodeError):
            raise ClsError(-22, f"numops.{op} wants 'key <number>'")
        raw = ctx.omap_get([key]).get(key) if ctx.exists else None
        try:
            cur = float(raw.decode()) if raw is not None else 0.0
        except ValueError:
            raise ClsError(-22, "stored value is not a number")
        import math

        new = cur + delta if op == "add" else cur * delta
        if not math.isfinite(new):
            raise ClsError(-22, "result is not finite")
        out = repr(int(new)) if new == int(new) else repr(new)
        ctx.omap_set({key: out.encode()})
        return out.encode()

    h.register("numops", "add", CLS_RD | CLS_WR,
               lambda c, d: _numops(c, d, "add"))
    h.register("numops", "mul", CLS_RD | CLS_WR,
               lambda c, d: _numops(c, d, "mul"))

    # cls_timeindex (reference src/cls/timeindex/): time-keyed entries
    # with ranged list + trim — the log/usage-record index shape
    @_guard_input
    def timeindex_add(ctx: MethodContext, indata: bytes) -> bytes:
        req = _json.loads(indata.decode())
        ts = float(req.get("ts", _time.time()))
        key = f"ti.{ts:020.6f}.{req['key']}"
        ctx.omap_set({key: req.get("value", "").encode()})
        return key.encode()

    @_guard_input
    def timeindex_list(ctx: MethodContext, indata: bytes) -> bytes:
        if not ctx.exists:
            return b"[]"
        req = _json.loads(indata.decode()) if indata else {}
        lo = float(req.get("from", 0.0))
        hi = float(req.get("to", 1e18))
        limit = int(req.get("max", 1000))
        out = []
        for k, v in sorted(ctx.omap_get().items()):
            if not k.startswith("ti."):
                continue
            parts = k.split(".", 3)
            ts = float(parts[1] + "." + parts[2])
            if lo <= ts < hi:
                out.append({"ts": ts, "key": parts[3],
                            "value": v.decode()})
                if len(out) >= limit:
                    break
        return _json.dumps(out).encode()

    @_guard_input
    def timeindex_trim(ctx: MethodContext, indata: bytes) -> bytes:
        if not ctx.exists:
            return b"0"
        req = _json.loads(indata.decode())
        upto = float(req["to"])
        doomed = []
        for k in ctx.omap_get():
            if k.startswith("ti."):
                parts = k.split(".", 3)
                if float(parts[1] + "." + parts[2]) < upto:
                    doomed.append(k)
        if doomed:
            ctx.omap_rm(doomed)
        return str(len(doomed)).encode()

    h.register("timeindex", "add", CLS_RD | CLS_WR, timeindex_add)
    h.register("timeindex", "list", CLS_RD, timeindex_list)
    h.register("timeindex", "trim", CLS_RD | CLS_WR, timeindex_trim)

    # cls_otp (reference src/cls/otp/cls_otp.cc): RFC-6238 TOTP tokens
    # verified INSIDE the OSD so the seed never leaves the object and
    # replay checks are atomic in the PG write pipeline.  A token is
    # {id, seed(hex), step, window, digits}; check() accepts a code if
    # it matches any step within +/-window and that step is NEWER than
    # the last accepted one (replay protection, the reference's
    # last_success bookkeeping).
    import hashlib as _hashlib
    import hmac as _hmac
    import struct as _struct

    def _totp(seed: bytes, counter: int, digits: int) -> str:
        mac = _hmac.new(seed, _struct.pack(">Q", counter),
                        _hashlib.sha1).digest()
        off = mac[-1] & 0xF
        code = (_struct.unpack(">I", mac[off:off + 4])[0]
                & 0x7FFFFFFF) % (10 ** digits)
        return f"{code:0{digits}d}"

    def _otp_key(tid: str) -> str:
        return f"otp.{tid}"

    @_guard_input
    def otp_set(ctx: MethodContext, indata: bytes) -> bytes:
        req = _json.loads(indata.decode())
        tid, seed = req["id"], req["seed"]
        try:
            bytes.fromhex(seed)
        except ValueError:
            raise ClsError(-22, "seed must be hex")
        tok = {"id": tid, "seed": seed,
               "step": int(req.get("step", 30)),
               "window": int(req.get("window", 1)),
               "digits": int(req.get("digits", 6)),
               "last_counter": -1}
        if tok["step"] <= 0 or not 6 <= tok["digits"] <= 10:
            raise ClsError(-22, "bad step/digits")
        ctx.omap_set({_otp_key(tid): _json.dumps(tok).encode()})
        return b""

    @_guard_input
    def otp_remove(ctx: MethodContext, indata: bytes) -> bytes:
        key = _otp_key(indata.decode())
        if key not in ctx.omap_get([key]):
            raise ClsError(-2, "no such token")
        ctx.omap_rm([key])
        return b""

    @_guard_input
    def otp_list(ctx: MethodContext, indata: bytes) -> bytes:
        if not ctx.exists:
            return b"[]"
        ids = [k[len("otp."):] for k in sorted(ctx.omap_get())
               if k.startswith("otp.")]
        return _json.dumps(ids).encode()

    @_guard_input
    def otp_check(ctx: MethodContext, indata: bytes) -> bytes:
        req = _json.loads(indata.decode())
        key = _otp_key(req["id"])
        got = ctx.omap_get([key])
        if key not in got:
            raise ClsError(-2, "no such token")
        tok = _json.loads(got[key].decode())
        now = float(req.get("now", _time.time()))
        counter = int(now // tok["step"])
        seed = bytes.fromhex(tok["seed"])
        code = str(req["code"])
        result = "fail"
        for c in range(counter - tok["window"],
                       counter + tok["window"] + 1):
            if c < 0 or not _hmac.compare_digest(
                    _totp(seed, c, tok["digits"]), code):
                continue
            if c <= tok["last_counter"]:
                result = "replay"  # code already consumed
                break
            tok["last_counter"] = c
            result = "ok"
            break
        tok["last_check"] = now
        tok["last_result"] = result
        ctx.omap_set({key: _json.dumps(tok).encode()})
        return result.encode()

    @_guard_input
    def otp_get_result(ctx: MethodContext, indata: bytes) -> bytes:
        key = _otp_key(indata.decode())
        got = ctx.omap_get([key])
        if key not in got:
            raise ClsError(-2, "no such token")
        tok = _json.loads(got[key].decode())
        return _json.dumps({
            "last_check": tok.get("last_check"),
            "last_result": tok.get("last_result", "none")}).encode()

    h.register("otp", "set", CLS_RD | CLS_WR, otp_set)
    h.register("otp", "remove", CLS_RD | CLS_WR, otp_remove)
    h.register("otp", "list", CLS_RD, otp_list)
    h.register("otp", "check", CLS_RD | CLS_WR, otp_check)
    h.register("otp", "get_result", CLS_RD, otp_get_result)

