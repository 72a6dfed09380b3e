"""The port's object classes (``ceph_tpu_torch/osd/cls.py``), its PG's
``OP_CALL`` route and its EC plugin loader, held against ``ceph_tpu``.

- Every method ``osd/cls.py`` registers, in a fresh ``ClassHandler`` of
  each package (the two sets of names equal; the singletons also hold
  what other modules register when imported, such as the reference's
  rgw and cephfs classes, which come with their slices), runs on equal
  ``MethodContext``s: each seeded
  input of a pool that covers every family's good and bad payloads, on
  an absent object, on a populated one writable and read-only.  The out
  bytes, the ``ClsError`` errno (or the escaping exception), the
  ``ObjectState`` after the call, ``exists`` and ``delete_object`` must
  be equal.
- The cls cases of ``tests/test_striper_cls.py`` (``:100,119,132,143``)
  and ``tests/test_cls_families.py`` (``:35,66,83,199,239``), as their
  assertions go, as ``OP_CALL`` ``MOSDOp``s through both packages' PGs
  in ``torch_pg_harness.Net`` (a replicated pool of 3 and isa k=2 m=1),
  with every reply, every message each host received and every store
  compared.  Their ``client.rados`` form waits for the port's client
  (ROADMAP queue 1 item 1j).
- The EC plugin load-failure cases of ``tests/test_cls_families.py``
  (``:102,118,128,158``) over the port's registry, whose factories take
  ``device=``.

``time.time`` is pinned for both packages (timeindex and otp read it,
and log entries carry it).
"""

import importlib
import json
import os
import sys
import tempfile
import textwrap
import time
import types

import pytest

import test_torch_pg_xcheck as X
import torch_pg_harness as H

PKGS = ("ceph_tpu", "ceph_tpu_torch")
CLOCK = X.CLOCK
SEED_HEX = "3132333435363738393031323334353637383930"  # RFC 6238 vector
NOW = 1_700_000_000.0


def _cls(pkg):
    return importlib.import_module(f"{pkg}.osd.cls")


# what cls.py itself registers, apart from the process's singletons
HANDLERS = {pkg: _cls(pkg).ClassHandler() for pkg in PKGS}


def _totp_ref(seed_hex: str, t: float, step: int = 30,
              digits: int = 6) -> str:
    """Independent RFC-6238 computation for the test side."""
    import hashlib
    import hmac
    import struct

    counter = int(t // step)
    mac = hmac.new(bytes.fromhex(seed_hex), struct.pack(">Q", counter),
                   hashlib.sha1).digest()
    off = mac[-1] & 0xF
    code = (struct.unpack(">I", mac[off:off + 4])[0]
            & 0x7FFFFFFF) % (10 ** digits)
    return f"{code:0{digits}d}"


def _j(obj) -> bytes:
    return json.dumps(obj).encode()


# every family's payloads, good and bad: each method gets every one
INPUTS = [
    b"", b"{}", b"not json", b"\xff\xfe", b"user1", b"default", b"7", b"8",
    b"seq", b"seq 10", b"seq x", b"x 5", b"x 2.5", b"x 0.1", b"x inf",
    b"x 1e308", b"bad 1", b"garbage", b"mirrorA", b"tok1",
    _j({"name": "l1", "owner": "client.a"}),
    _j({"name": "l1", "owner": "client.b"}),
    _j({"name": "l1", "owner": "client.b", "type": "shared"}),
    _j({"name": "l2", "owner": "client.a", "type": "shared"}),
    _j({"id": "mirrorA"}), _j({"id": "mirrorB", "commit": 5}),
    _j({"id": "mirrorA", "commit": 9}), _j({"id": "nobody", "commit": 1}),
    _j({"ts": 20.0, "key": "e1", "value": "v1"}),
    _j({"key": "now", "value": "pinned"}),
    _j({"from": 15, "to": 35}), _j({"from": 0, "to": 1e18, "max": 1}),
    _j({"to": 25}), _j({"to": "x"}),
    _j({"id": "tok1", "seed": SEED_HEX}),
    _j({"id": "t2", "seed": "zz"}),
    _j({"id": "t3", "seed": SEED_HEX, "step": 0}),
    _j({"id": "tok1", "code": _totp_ref(SEED_HEX, NOW), "now": NOW}),
    _j({"id": "tok1", "code": _totp_ref(SEED_HEX, NOW - 30), "now": NOW}),
    _j({"id": "tok1", "code": "000000", "now": NOW + 300}),
    _j({"id": "tok1", "code": _totp_ref(SEED_HEX, CLOCK)}),
    _j({"id": "ghost", "code": "123456"}),
]


NEVER_REFUSE = ("journal.client_list", "otp.list", "refcount.read",
                "version.get")


def _populated(pkg):
    """An object holding what every family reads: a lock, refs, a
    version, counters, journal clients, time-index entries, an otp
    token, and an omap value that is not a number."""
    be = importlib.import_module(f"{pkg}.osd.backend")
    tok = {"id": "tok1", "seed": SEED_HEX, "step": 30, "window": 1,
           "digits": 6, "last_counter": int(NOW // 30) - 1}
    return be.ObjectState(
        b"payload-bytes",
        {"lock.l1": _j({"type": "exclusive", "owners": ["client.a"]}),
         "refcount": _j(["user1", "user2"]), "cls_version": b"7",
         "user.k": b"v"},
        {"seq": b"41", "x": b"3", "bad": b"not-a-number",
         "jclient.mirrorA": _j({"id": "mirrorA", "commit": 4, "data": ""}),
         "ti.00000000010.000000.e0": b"v0",
         "ti.00000000030.000000.e2": b"v2",
         "otp.tok1": _j(tok)})


def _apply(pkg, name, indata, variant):
    c = _cls(pkg)
    be = importlib.import_module(f"{pkg}.osd.backend")
    if variant == "absent":
        st, exists, writable = be.ObjectState(), False, True
    else:
        st, exists, writable = _populated(pkg), True, variant == "rw"
    ctx = c.MethodContext(st, exists, writable)
    _flags, fn = HANDLERS[pkg].get(name)
    try:
        got = ("out", fn(ctx, indata))
    except c.ClsError as e:
        got = ("cls", e.errno, str(e))
    except Exception as e:  # noqa: BLE001 — compared, never swallowed
        got = ("raised", type(e).__name__, str(e))
    return got, (bytes(st.data), dict(st.xattrs), dict(st.omap),
                 ctx.exists, ctx.delete_object)


def test_both_class_handlers_register_the_same_methods():
    ref, port = (HANDLERS[p] for p in PKGS)
    assert port.names() == ref.names()
    for name in ref.names():
        assert port.get(name)[0] == ref.get(name)[0], name
        assert port.is_write(name) == ref.is_write(name), name
    # the port's singleton is its own, and holds every method of cls.py
    single = _cls("ceph_tpu_torch").ClassHandler.instance()
    assert single is not _cls("ceph_tpu").ClassHandler.instance()
    assert set(port.names()) <= set(single.names())


@pytest.mark.parametrize("name", HANDLERS["ceph_tpu"].names())
def test_method_answers_and_mutates_as_the_reference(name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    outcomes = set()
    for indata in INPUTS:
        for variant in ("absent", "rw", "ro"):
            want = _apply("ceph_tpu", name, indata, variant)
            got = _apply("ceph_tpu_torch", name, indata, variant)
            assert got == want, (name, indata, variant)
            outcomes.add(want[0][0])
    # the pool reaches each method's answer and, but for the four reads
    # that answer whatever they get, its refusal
    assert "out" in outcomes, (name, outcomes)
    assert (len(outcomes) > 1) == (name not in NEVER_REFUSE), (name,
                                                                outcomes)


# -- the cls cases over both packages' PGs ---------------------------------

class _IO:
    """The ``IoCtx`` calls the cases make, as ``MOSDOp``s into the net's
    primary: each answers the reply, and ``replies`` keeps its bytes."""

    def __init__(self, net) -> None:
        self.net = net
        self.t = net.mods.t
        self.replies = []
        self._n = 0

    def operate(self, oid, ops):
        self._n += 1
        rep = self.net.op(oid, ops, reqid=f"client.1:{self._n}")
        self.net.settle()
        self.replies.append(rep.blob)
        return rep

    def call(self, oid, cls, method, indata=b""):
        t = self.t
        return self.operate(oid, [t.OSDOp(t.OP_CALL, name=f"{cls}.{method}",
                                          data=indata)])

    def out(self, oid, cls, method, indata=b""):
        rep = self.call(oid, cls, method, indata)
        assert rep.result == 0, (cls, method, indata, rep.result)
        return bytes(rep.ops[0].out_data)

    def write_full(self, oid, data):
        t = self.t
        assert self.operate(oid, [t.OSDOp(t.OP_WRITEFULL,
                                          data=data)]).result == 0

    def read(self, oid):
        t = self.t
        return self.operate(oid, [t.OSDOp(t.OP_READ)])

    def omap_set(self, oid, kv):
        t = self.t
        assert self.operate(oid, [t.OSDOp(t.OP_OMAP_SET, kv=kv)]).result == 0


def case_lock_exclusive(io, pkg):
    io.write_full("locked", b"payload")
    io.out("locked", "lock", "lock", b'{"name": "l1", "owner": "client.a"}')
    # second owner is refused
    assert io.call("locked", "lock", "lock",
                   b'{"name": "l1", "owner": "client.b"}').result == -16
    info = io.out("locked", "lock", "get_info", b'{"name": "l1"}')
    assert b"client.a" in info
    io.out("locked", "lock", "unlock", b'{"name": "l1", "owner": "client.a"}')
    # now free for the other owner
    io.out("locked", "lock", "lock", b'{"name": "l1", "owner": "client.b"}')


def case_refcount_delete_on_zero(io, pkg):
    io.write_full("counted", b"shared")
    io.out("counted", "refcount", "get", b"user1")
    io.out("counted", "refcount", "get", b"user2")
    assert b"user1" in io.out("counted", "refcount", "read")
    io.out("counted", "refcount", "put", b"user1")
    rep = io.read("counted")
    assert bytes(rep.ops[0].out_data) == b"shared"  # still referenced
    io.out("counted", "refcount", "put", b"user2")
    assert io.read("counted").result == -2  # last ref dropped: deleted


def case_version_check(io, pkg):
    io.write_full("versioned", b"v")
    io.out("versioned", "version", "set", b"7")
    assert io.out("versioned", "version", "get") == b"7"
    io.out("versioned", "version", "check", b"7")
    assert io.call("versioned", "version", "check", b"8").result == -22


def case_runtime_registration(io, pkg):
    """Third-party classes register at runtime (the reference's
    dlopen-a-new-.so extension point)."""
    c = _cls(pkg)
    h = c.ClassHandler.instance()
    h.register("demo", "upper", c.CLS_RD, lambda ctx, indata: indata.upper())
    try:
        io.write_full("demo1", b"x")
        assert io.out("demo1", "demo", "upper", b"hello") == b"HELLO"
        # unknown method surfaces EINVAL
        assert io.call("demo1", "demo", "nope").result == -22
    finally:
        h._methods.pop("demo.upper", None)


def case_journal_clients(io, pkg):
    oid = "jmeta"
    io.out(oid, "journal", "client_register", _j({"id": "mirrorA"}))
    io.out(oid, "journal", "client_register",
           _j({"id": "mirrorB", "commit": 5}))
    # duplicate registration is EEXIST
    assert io.call(oid, "journal", "client_register",
                   _j({"id": "mirrorA"})).result == -17
    # commit positions are monotonic
    io.out(oid, "journal", "client_commit", _j({"id": "mirrorA", "commit": 9}))
    io.out(oid, "journal", "client_commit", _j({"id": "mirrorA", "commit": 3}))
    got = json.loads(io.out(oid, "journal", "get_client", b"mirrorA"))
    assert got["commit"] == 9
    clients = json.loads(io.out(oid, "journal", "client_list", b""))
    assert [c["id"] for c in clients] == ["mirrorA", "mirrorB"]
    io.out(oid, "journal", "client_unregister", b"mirrorB")
    clients = json.loads(io.out(oid, "journal", "client_list", b""))
    assert [c["id"] for c in clients] == ["mirrorA"]


def case_numops(io, pkg):
    oid = "nums"
    assert io.out(oid, "numops", "add", b"x 5") == b"5"
    assert io.out(oid, "numops", "add", b"x 2.5") == b"7.5"
    assert io.out(oid, "numops", "mul", b"x 2") == b"15"
    assert io.call(oid, "numops", "add", b"garbage").result == -22
    # non-numeric stored value is EINVAL, like the reference
    io.omap_set(oid, {"bad": b"not-a-number"})
    assert io.call(oid, "numops", "add", b"bad 1").result == -22


def case_timeindex(io, pkg):
    oid = "tindex"
    for i, ts in enumerate((10.0, 20.0, 30.0, 40.0)):
        io.out(oid, "timeindex", "add",
               _j({"ts": ts, "key": f"e{i}", "value": f"v{i}"}))
    got = json.loads(io.out(oid, "timeindex", "list",
                            _j({"from": 15, "to": 35})))
    assert [e["key"] for e in got] == ["e1", "e2"]
    assert int(io.out(oid, "timeindex", "trim", _j({"to": 25}))) == 2
    got = json.loads(io.out(oid, "timeindex", "list", b""))
    assert [e["key"] for e in got] == ["e2", "e3"]


def case_otp(io, pkg):
    oid = "otp_store"
    seed = SEED_HEX
    io.out(oid, "otp", "set", _j({"id": "tok1", "seed": seed}))
    assert json.loads(io.out(oid, "otp", "list")) == ["tok1"]
    now = NOW
    good = _totp_ref(seed, now)
    assert io.out(oid, "otp", "check",
                  _j({"id": "tok1", "code": good, "now": now})) == b"ok"
    # replay: the same code is consumed
    assert io.out(oid, "otp", "check",
                  _j({"id": "tok1", "code": good, "now": now})) == b"replay"
    bad = f"{(int(good) + 1) % 1_000_000:06d}"
    assert io.out(oid, "otp", "check",
                  _j({"id": "tok1", "code": bad, "now": now})) == b"fail"
    res = json.loads(io.out(oid, "otp", "get_result", b"tok1"))
    assert res["last_result"] == "fail"
    # next step's code works (monotonic counter)
    nxt = _totp_ref(seed, now + 30)
    assert io.out(oid, "otp", "check",
                  _j({"id": "tok1", "code": nxt, "now": now + 30})) == b"ok"
    # window: a code one step old is accepted once
    now2 = now + 300
    prev = _totp_ref(seed, now2 - 30)
    assert io.out(oid, "otp", "check",
                  _j({"id": "tok1", "code": prev, "now": now2})) == b"ok"
    io.out(oid, "otp", "remove", b"tok1")
    assert json.loads(io.out(oid, "otp", "list")) == []
    assert io.call(oid, "otp", "check",
                   _j({"id": "tok1", "code": "000000"})).result == -2
    assert io.call(oid, "otp", "set",
                   _j({"id": "t2", "seed": "zz"})).result == -22


def case_buggy_method_fails_op(io, pkg):
    """A method that raises a non-ClsError comes back as -EIO, promptly,
    and the object is untouched."""
    c = _cls(pkg)
    h = c.ClassHandler.instance()

    def boom(ctx, indata):
        raise TypeError("not a ClsError")

    h.register("testbug", "boom", c.CLS_RD | c.CLS_WR, boom)
    try:
        assert io.call("bugobj", "testbug", "boom", b"").result == -5
        assert io.read("bugobj").result == -2
    finally:
        h._methods.pop("testbug.boom", None)


CASES = {f.__name__[len("case_"):]: f for f in (
    case_lock_exclusive, case_refcount_delete_on_zero, case_version_check,
    case_runtime_registration, case_journal_clients, case_numops,
    case_timeindex, case_otp, case_buggy_method_fails_op)}
POOLS = {"replicated_3": X.PROFILES["replicated_3"],
         "isa_2_1": X.PROFILES["isa_2_1"]}


def _run_case(pkg, pool, case) -> dict:
    profile, n_osds = POOLS[pool]
    net = H.Net(pkg, profile, n_osds)
    try:
        io = _IO(net)
        CASES[case](io, pkg)
        return {"replies": io.replies,
                "received": [X._by_source(h.received) for h in net.hosts],
                "stores": [X._dump_store(h) for h in net.hosts],
                "pgs": X._pg_state(net),
                "logged": [h.logged for h in net.hosts]}
    finally:
        net.stop()


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_call_through_both_packages_pgs(case, pool, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    ref = _run_case("ceph_tpu", pool, case)
    port = _run_case("ceph_tpu_torch", pool, case)
    for key in ref:
        assert port[key] == ref[key], key


# -- the EC plugin loader (test_cls_families.py:102,118,128,158) -----------

def test_ec_plugin_unknown_and_failing_init():
    from ceph_tpu_torch.ec import instance
    from ceph_tpu_torch.ec.interface import ErasureCodeError

    reg = instance()
    with pytest.raises(ErasureCodeError, match="unknown"):
        reg.factory("no-such-plugin", {}, device="cpu")

    def exploding_factory(profile, device=None):
        raise RuntimeError("boom at init")

    reg._factories.setdefault("explodes", exploding_factory)
    try:
        with pytest.raises(ErasureCodeError, match="failed to initialize"):
            reg.factory("explodes", {"k": "2", "m": "1"}, device="cpu")
    finally:
        reg._factories.pop("explodes", None)


def test_ec_plugin_missing_entry_point():
    from ceph_tpu_torch.ec import instance
    from ceph_tpu_torch.ec.interface import ErasureCodeError

    sys.modules["fake_ec_no_entry"] = types.ModuleType("fake_ec_no_entry")
    try:
        with pytest.raises(ErasureCodeError, match="entry point"):
            instance().load_module("broken", "fake_ec_no_entry")
    finally:
        del sys.modules["fake_ec_no_entry"]


def test_ec_plugin_import_failure_and_hang():
    from ceph_tpu_torch.ec import instance
    from ceph_tpu_torch.ec.interface import ErasureCodeError

    reg = instance()
    with pytest.raises(ErasureCodeError, match="failed to load"):
        reg.load_module("ghost", "definitely_not_a_module_xyz")
    # a module whose import hangs: its top-level code sleeps
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "fake_ec_hangs_port.py"), "w") as f:
        f.write(textwrap.dedent("""
            import time
            time.sleep(60)
        """))
    sys.path.insert(0, d)
    try:
        with pytest.raises(ErasureCodeError, match="hung"):
            reg.load_module("hangs", "fake_ec_hangs_port", timeout_s=1.0)
    finally:
        sys.path.remove(d)
        sys.modules.pop("fake_ec_hangs_port", None)
    assert "hangs" not in reg._factories


def test_ec_plugin_successful_third_party_load():
    from ceph_tpu_torch.ec import instance

    mod = types.ModuleType("fake_ec_good")

    class _Fake:
        pass

    def ec_plugin_create(profile, device=None):
        f = _Fake()
        f.profile, f.device = profile, device
        return f

    mod.ec_plugin_create = ec_plugin_create
    sys.modules["fake_ec_good"] = mod
    reg = instance()
    try:
        reg.load_module("thirdparty", "fake_ec_good")
        got = reg.factory("thirdparty", {"k": "4"}, device="cpu")
        assert got.profile == {"k": "4"} and str(got.device) == "cpu"
    finally:
        del sys.modules["fake_ec_good"]
        reg._factories.pop("thirdparty", None)


def test_ec_plugin_preload():
    """The default set preloads, clay with it (the reference's set), and
    an unknown plugin fails the preload."""
    import sys

    from ceph_tpu_torch.ec import instance
    from ceph_tpu_torch.ec.interface import ErasureCodeError

    reg = instance()
    reg.preload()
    assert "ceph_tpu_torch.ec.clay" in sys.modules
    reg.preload(("clay",))
    with pytest.raises(ErasureCodeError, match="cannot preload"):
        reg.preload(("no-such-plugin",))
