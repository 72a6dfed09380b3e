"""The port's wire and store layers against ``ceph_tpu``'s, on the CPU.

- Messages (``MPing``, ``MAck`` with an authorizer, and a test-local
  payload message registered in both registries under one type id)
  encode to the same bytes in both packages, and so do their frames
  (length, CRC-32C, body).
- The two packages' messengers talk over 127.0.0.1 in both directions
  with cephx on both sides: a port authorizer verified by the
  reference's verifier and the other way round; sent, dispatched and
  replied over the same session.
- Cephx: the nonces come from ``secrets``, so sealed bytes differ from
  run to run; a blob sealed by one package unseals in the other,
  tampering is refused by both, a ticket issued by one server is taken
  by the other package's client, and the replay and target-binding
  rules agree.
- ``Transaction.to_bytes()`` of a seeded op sequence is equal in both.
- One seeded op sequence applied to both ``MemStore``s: after every
  step the data, size, attributes, omap, collection listings,
  ``ExtentSeals`` bytes and the errors raised are equal.
"""

import secrets
import threading
import time

import numpy as np
import pytest

from ceph_tpu import auth as ref_auth
from ceph_tpu.core.context import Context as RefContext
from ceph_tpu.msg import message as ref_message
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.store import memstore as ref_memstore
from ceph_tpu.store import objectstore as ref_os
from ceph_tpu_torch import auth
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.msg import message, messenger
from ceph_tpu_torch.store import memstore
from ceph_tpu_torch.store import objectstore as port_os

WAIT_S = 10.0
TYPE_ECHO = 9101
TYPE_REPLY = 9102


def _payload_types(msg_mod):
    class Echo(msg_mod.Message):
        TYPE = TYPE_ECHO
        VERSION = 2

        def __init__(self, text: str = "", data: bytes = b"",
                     n: int = 0) -> None:
            super().__init__()
            self.text = text
            self.data = data
            self.n = n

        def encode_payload(self, e) -> None:
            e.string(self.text).blob(self.data).s64(self.n)

        def decode_payload(self, d) -> None:
            self.text = d.string()
            self.data = d.blob()
            self.n = d.s64()

    class Reply(Echo):
        TYPE = TYPE_REPLY

    return msg_mod.register(Echo), msg_mod.register(Reply)


RefEcho, RefReply = _payload_types(ref_message)
PortEcho, PortReply = _payload_types(message)


def _header(m, msg_mod, rng):
    m.seq = int(rng.integers(1, 1 << 40))
    m.tid = int(rng.integers(0, 1 << 62))
    m.priority = int(rng.integers(0, 256))
    m.ack_seq = int(rng.integers(0, 1 << 40))
    m.nonce = int(rng.integers(1, 1 << 62))
    m.sid = int(rng.integers(1, 1 << 62))
    m.src = msg_mod.EntityName("osd", int(rng.integers(0, 1000)))
    return m


def _messages(msg_mod, echo, seed):
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, 4099, dtype=np.uint8).tobytes()
    ack = msg_mod.MAck()
    ack.auth_blob = blob[:200]
    msgs = [msg_mod.MPing(), msg_mod.MAck(), ack,
            echo("héllo", blob, -7), echo("", b"", 0)]
    return [_header(m, msg_mod, rng) for m in msgs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_messages_encode_to_the_same_bytes(seed):
    ref = _messages(ref_message, RefEcho, seed)
    port = _messages(message, PortEcho, seed)
    for r, p in zip(ref, port):
        rb, pb = r.to_bytes(), p.to_bytes()
        assert rb == pb, type(p).__name__
        back = message.Message.from_bytes(rb)
        assert type(back).__name__ == type(p).__name__
        assert (back.seq, back.tid, back.src, back.nonce, back.sid) == \
            (p.seq, p.tid, p.src, p.nonce, p.sid)
        again = ref_message.Message.from_bytes(pb)
        assert again.to_bytes() == rb


@pytest.fixture
def messenger_pair():
    """One started messenger of each package (no peer is dialed)."""
    r = ref_messenger.Messenger(None, ref_message.EntityName("osd", 1))
    p = messenger.Messenger(None, message.EntityName("osd", 1))
    r.start()
    p.start()
    yield r, p
    r.shutdown()
    p.shutdown()


@pytest.mark.parametrize("crc_data", [True, False])
def test_frames_and_their_crcs_are_equal(messenger_pair, crc_data):
    r, p = messenger_pair
    r.crc_data = p.crc_data = crc_data
    for rm, pm in zip(_messages(ref_message, RefEcho, 5),
                      _messages(message, PortEcho, 5)):
        rf, pf = bytes(r._frame_of(rm)), bytes(p._frame_of(pm))
        assert rf == pf
        assert len(pf) == 8 + len(pm.to_bytes())
    r.nonce = p.nonce  # the ack names its sender's incarnation
    assert bytes(r._ack_frame(77)) == bytes(p._ack_frame(77))


# -- messengers of both packages on one wire ---------------------------------


class _Server:
    """Dispatcher mixin body: records each echo and replies with its
    text upper-cased over the same session."""

    def __init__(self, reply_cls):
        self.got = []
        self.cond = threading.Condition()
        self.reply_cls = reply_cls

    def ms_dispatch(self, conn, msg):
        with self.cond:
            self.got.append(msg)
            self.cond.notify_all()
        if type(msg).__name__ == "Echo":
            conn.send(self.reply_cls(msg.text.upper(), msg.data[::-1],
                                     msg.n + 1))
        return True

    def wait(self, pred):
        with self.cond:
            return self.cond.wait_for(lambda: pred(self.got), WAIT_S)


def _dispatcher(msgr_mod, reply_cls):
    class D(_Server, msgr_mod.Dispatcher):
        pass

    return D(reply_cls)


def _verifier(verify, service_secret, verdicts):
    def check(blob):
        try:
            verify(service_secret, blob)
            verdicts.append(True)
            return True
        except Exception:
            verdicts.append(False)
            return False
    return check


def _ticket(server, client_cls, name, secret):
    cx = client_cls(name, secret)
    ch = server.get_challenge(name)
    cc = secrets.token_bytes(16)
    sealed, ticket = server.handle_request(name, cc, cx.make_proof(ch, cc))
    cx.accept_reply(sealed, ticket)
    return cx


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_messengers_of_both_packages_talk_with_cephx(dialer):
    """The dialer's package builds the authorizer from a ticket the
    OTHER package's auth server issued; the acceptor (the other
    package) verifies it with its own verify_authorizer, dispatches the
    echo and replies over the session."""
    kr = auth.Keyring()
    kr.add("service")
    secret = kr.add("client.4")
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    if dialer == "port":
        server = ref_auth.CephxServer(ref_auth.Keyring.loads(kr.dump()))
        cx = _ticket(server, auth.CephxClient, "client.4", secret)
        d_mod, d_msg, d_echo, d_ctx = messenger, message, PortEcho, Context
        a_mod, a_msg, a_reply, a_ctx = (ref_messenger, ref_message,
                                        RefReply, RefContext)
        verify = ref_auth.verify_authorizer
    else:
        server = auth.CephxServer(kr)
        cx = _ticket(server, ref_auth.CephxClient, "client.4", secret)
        d_mod, d_msg, d_echo, d_ctx = (ref_messenger, ref_message, RefEcho,
                                       RefContext)
        a_mod, a_msg, a_reply, a_ctx = messenger, message, PortReply, Context
        verify = auth.verify_authorizer
    verdicts = []
    acceptor = a_mod.Messenger(a_ctx("osd.0"), a_msg.EntityName("osd", 0))
    srv = _dispatcher(a_mod, a_reply)
    acceptor.add_dispatcher(srv)
    acceptor.set_auth(verifier=_verifier(verify, server.service_secret,
                                         verdicts))
    dial = d_mod.Messenger(d_ctx("client.4"), d_msg.EntityName("client", 4))
    cli = _dispatcher(d_mod, None)
    dial.add_dispatcher(cli)
    dial.set_auth(provider=cx.build_authorizer)
    acceptor.start()
    dial.start()
    try:
        conn = dial.connect(acceptor.addr)
        for i in range(3):
            conn.send(d_echo(f"m{i}", data[i:], i))
        assert srv.wait(lambda got: len(got) == 3)
        assert [m.text for m in srv.got] == ["m0", "m1", "m2"]
        assert all(m.data == data[i:] and m.n == i
                   for i, m in enumerate(srv.got))
        assert srv.got[0].src == a_msg.EntityName("client", 4)
        assert cli.wait(lambda got: len(got) == 3)
        assert [(m.text, m.data, m.n) for m in cli.got] == \
            [(f"M{i}", data[i:][::-1], i + 1) for i in range(3)]
        assert verdicts == [True]
    finally:
        dial.shutdown()
        acceptor.shutdown()


@pytest.mark.parametrize("acceptor_pkg", ["port", "reference"])
def test_unauthenticated_dialer_of_the_other_package_is_refused(
        acceptor_pkg):
    kr = auth.Keyring()
    kr.add("service")
    if acceptor_pkg == "port":
        a_mod, a_msg, d_mod, d_msg, d_echo = (
            messenger, message, ref_messenger, ref_message, RefEcho)
        server = auth.CephxServer(kr)
        verify = auth.verify_authorizer
    else:
        a_mod, a_msg, d_mod, d_msg, d_echo = (
            ref_messenger, ref_message, messenger, message, PortEcho)
        server = ref_auth.CephxServer(ref_auth.Keyring.loads(kr.dump()))
        verify = ref_auth.verify_authorizer
    verdicts = []
    acceptor = a_mod.Messenger(None, a_msg.EntityName("osd", 0))
    srv = _dispatcher(a_mod, None)
    acceptor.add_dispatcher(srv)
    acceptor.set_auth(verifier=_verifier(verify, server.service_secret,
                                         verdicts))
    bad = d_mod.Messenger(None, d_msg.EntityName("client", 666))
    acceptor.start()
    bad.start()
    try:
        bad.send_message(d_echo("nope"), acceptor.addr)
        deadline = time.monotonic() + WAIT_S
        while verdicts.count(False) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert verdicts.count(False) >= 2 and True not in verdicts
        assert srv.got == []
    finally:
        bad.shutdown()
        acceptor.shutdown()


# -- cephx -------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4096])
def test_sealed_blobs_cross_unseal_and_tamper_is_refused(n):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    plain = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for seal, unseal in ((auth.seal, ref_auth.unseal),
                         (ref_auth.seal, auth.unseal)):
        blob = seal(key, plain)
        assert len(blob) == 48 + n
        assert unseal(key, blob) == plain
        for pos in (0, 20, len(blob) - 1):
            bad = bytearray(blob)
            bad[pos] ^= 1
            for pkg in (auth, ref_auth):
                with pytest.raises(pkg.AuthError):
                    pkg.unseal(key, bytes(bad))
        for pkg in (auth, ref_auth):
            with pytest.raises(pkg.AuthError):
                pkg.unseal(b"x" * 32, blob)
            with pytest.raises(pkg.AuthError):
                pkg.unseal(key, blob[:47])


def test_tickets_keyrings_and_handshakes_agree():
    t = dict(name="client.3", caps="allow rw", session_key=b"k" * 32,
             expires=1234.5)
    assert auth.Ticket(**t).encode() == ref_auth.Ticket(**t).encode()
    assert ref_auth.Ticket.decode(auth.Ticket(**t).encode()) == \
        ref_auth.Ticket(**t)
    kr = auth.Keyring()
    for name in ("mon.", "osd.0", "client.admin", "service"):
        kr.add(name)
    ref_kr = ref_auth.Keyring.loads(kr.dump())
    assert ref_kr.dump() == kr.dump()
    assert auth.Keyring.loads(ref_kr.dump()).dump() == kr.dump()
    # each package's client through the other's server, and a wrong
    # secret refused by both servers
    for server, client in ((auth.CephxServer(kr), ref_auth.CephxClient),
                           (ref_auth.CephxServer(ref_kr), auth.CephxClient)):
        cx = _ticket(server, client, "client.admin", kr.get("client.admin"))
        assert cx.authenticated
        for verify in (auth.verify_authorizer, ref_auth.verify_authorizer):
            tk = verify(server.service_secret, cx.build_authorizer())
            assert tk.name == "client.admin" and tk.caps == "allow *"
            assert tk.session_key == cx.session_key
        with pytest.raises(Exception, match="bad proof"):
            _ticket(server, client, "client.admin", b"wrong" * 8)


@pytest.mark.parametrize("maker", ["port", "reference"])
def test_replay_and_target_binding_rules_agree(maker):
    kr = auth.Keyring()
    kr.add("service")
    secret = kr.add("client.9")
    server = auth.CephxServer(kr)
    client = auth.CephxClient if maker == "port" else ref_auth.CephxClient
    cx = _ticket(server, client, "client.9", secret)
    tgt = "127.0.0.1:6800"
    seen = {pkg: {} for pkg in ("port", "reference")}
    verifiers = {"port": auth.verify_authorizer,
                 "reference": ref_auth.verify_authorizer}
    errors = {"port": auth.AuthError, "reference": ref_auth.AuthError}
    blob = cx.build_authorizer(target=tgt)
    for pkg, verify in verifiers.items():
        assert verify(server.service_secret, blob, expect_target=tgt,
                      seen=seen[pkg]).name == "client.9"
        with pytest.raises(errors[pkg], match="replayed"):
            verify(server.service_secret, blob, expect_target=tgt,
                   seen=seen[pkg])
    assert set(seen["port"]) == set(seen["reference"])
    other = cx.build_authorizer(target=tgt)
    unbound = cx.build_authorizer()
    for pkg, verify in verifiers.items():
        with pytest.raises(errors[pkg], match="bound to"):
            verify(server.service_secret, other,
                   expect_target="127.0.0.1:6801", seen={})
        with pytest.raises(errors[pkg], match="bound to"):
            verify(server.service_secret, unbound, expect_target=tgt)
        with pytest.raises(errors[pkg], match="skew"):
            verify(server.service_secret, other, expect_target=tgt,
                   now=time.time() + 400)
        with pytest.raises(errors[pkg], match="expired"):
            verify(server.service_secret, other, now=time.time() + 7200)


# -- transactions and the store ---------------------------------------------

COLLS = ["1.0_head", "1.1_head", "meta"]
NAMES = ["a", "b", "c"]
OPS = ["mkcoll", "rmcoll", "touch", "write", "zero", "truncate", "remove",
       "try_remove", "setattrs", "rmattr", "clone", "omap_setkeys",
       "omap_rmkeys", "omap_clear", "coll_move_rename"]
# writes dominate, as on a store's real traffic; every op still appears
WEIGHTS = np.array([1, 1, 2, 8, 2, 2, 1, 1, 3, 1, 2, 3, 1, 1, 1], float)
WEIGHTS /= WEIGHTS.sum()


def _random_txn(rng, os_mod, n_ops):
    """A seeded transaction of ``n_ops`` ops over a few collections and
    objects (many of them invalid on purpose)."""
    def cid():
        return os_mod.Collection(COLLS[int(rng.integers(len(COLLS)))])

    def oid():
        return os_mod.GHObject(NAMES[int(rng.integers(len(NAMES)))],
                               snap=int(rng.choice([-2, 3])),
                               shard=int(rng.choice([-1, 6])))

    def data():
        n = int(rng.choice([0, 1, 15, 16, 17, 40, 100]))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    t = os_mod.Transaction()
    for _ in range(n_ops):
        op = OPS[int(rng.choice(len(OPS), p=WEIGHTS))]
        if op == "mkcoll":
            t.create_collection(cid())
        elif op == "rmcoll":
            t.remove_collection(cid())
        elif op in ("touch", "remove", "try_remove", "omap_clear"):
            getattr(t, op)(cid(), oid())
        elif op == "write":
            t.write(cid(), oid(), int(rng.integers(0, 80)), data())
        elif op == "zero":
            t.zero(cid(), oid(), int(rng.integers(0, 80)),
                   int(rng.integers(0, 40)))
        elif op == "truncate":
            t.truncate(cid(), oid(), int(rng.integers(0, 120)))
        elif op == "setattrs":
            t.setattrs(cid(), oid(), {f"k{int(rng.integers(3))}": data()})
        elif op == "rmattr":
            t.rmattr(cid(), oid(), f"k{int(rng.integers(3))}")
        elif op == "clone":
            t.clone(cid(), oid(), oid())
        elif op == "omap_setkeys":
            t.omap_setkeys(cid(), oid(), {f"m{int(rng.integers(4))}": data(),
                                          "z": data()})
        elif op == "omap_rmkeys":
            t.omap_rmkeys(cid(), oid(), [f"m{int(rng.integers(4))}"])
        else:
            t.coll_move_rename(cid(), oid(), cid(), oid())
    return t


@pytest.mark.parametrize("seed", range(6))
def test_transaction_bytes_are_equal(seed):
    ref = _random_txn(np.random.default_rng(seed), ref_os, 40)
    port = _random_txn(np.random.default_rng(seed), port_os, 40)
    tb = port.to_bytes()
    assert ref.to_bytes() == tb
    back = port_os.Transaction.from_bytes(ref.to_bytes())
    assert back.to_bytes() == tb
    assert ref_os.Transaction.from_bytes(tb).to_bytes() == tb


def _snapshot(store, os_mod):
    """Everything a reader can see, with errors as (class, message)."""
    def attempt(fn, *a):
        try:
            return ("ok", fn(*a))
        except os_mod.StoreError as e:
            return (type(e).__name__, str(e))

    out = {"colls": [c.name for c in store.list_collections()],
           "statfs": store.statfs()}
    for cname in COLLS:
        cid = os_mod.Collection(cname)
        got = attempt(store.collection_list, cid)
        out[cname] = got
        if got[0] != "ok":
            continue
        for oid in got[1]:
            key = (cname, oid.name, oid.snap, oid.shard)
            out[key] = (
                attempt(store.read, cid, oid),
                attempt(store.read, cid, oid, 5, 20),
                attempt(store.read, cid, oid, 17, 0),
                attempt(store.stat, cid, oid),
                attempt(store.getattrs, cid, oid),
                attempt(store.getattr, cid, oid, "k1"),
                attempt(store.omap_get, cid, oid),
                attempt(store.omap_get_values, cid, oid, ["m1", "z"]),
                store._read_span(cid, oid, 0, 0)[2],
            )
        out[(cname, "missing")] = attempt(
            store.read, cid, os_mod.GHObject("nope"))
    return out


def _normalise(snap):
    """GHObject lists as plain tuples, so both packages' compare."""
    def fix(v):
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "ok" \
                and isinstance(v[1], list):
            return ("ok", [(o.name, o.snap, o.shard) for o in v[1]])
        return v
    return {k: fix(v) for k, v in snap.items()}


@pytest.mark.parametrize("extent", [16, 64 << 10])
@pytest.mark.parametrize("seed", range(4))
def test_memstores_agree_step_by_step(seed, extent):
    rng_ref = np.random.default_rng(1000 + seed)
    rng_port = np.random.default_rng(1000 + seed)
    ref, port = ref_memstore.MemStore(), memstore.MemStore()
    for s, os_mod in ((ref, ref_os), (port, port_os)):
        s.csum_extent_size = extent
        s.mkfs()
        s.mount()
        t = os_mod.Transaction()
        for cname in COLLS[:2]:
            t.create_collection(os_mod.Collection(cname))
        s.queue_transaction(t)
    applied = 0
    for step in range(60):
        n = int(rng_ref.integers(1, 5))
        assert n == int(rng_port.integers(1, 5))
        outcome = []
        for s, os_mod, rng in ((ref, ref_os, rng_ref),
                               (port, port_os, rng_port)):
            t = _random_txn(rng, os_mod, n)
            try:
                outcome.append(("ok", s.queue_transaction(t)))
            except os_mod.StoreError as e:
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1], f"step {step}"
        applied += outcome[1][0] == "ok"
        assert _normalise(_snapshot(ref, ref_os)) == \
            _normalise(_snapshot(port, port_os)), f"step {step}"
    assert applied >= 10  # the sequence did real work
    assert port.perf.value("read_verify_fail") == 0
