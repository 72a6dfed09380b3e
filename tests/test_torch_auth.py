"""The port's cephx-role authentication (``ceph_tpu_torch/auth/``), case
for case against ``tests/test_auth.py``: the protocol units, the keyring
file, messenger session gating, and authorizer replay and target
binding, and an authenticated cluster (all 9 of its cases).

``test_authenticated_cluster_io`` (``:190``) runs a port ``Monitor`` that
issues the tickets, three port ``OSDService``s that require authorizers
and a port ``RadosClient``, all with ``device="cpu"``.  Every socket
binds to 127.0.0.1; the gating case waits on the verifier's verdicts
with a deadline, not on a sleep, and the cluster case polls its boot.
"""

import hashlib
import hmac
import secrets
import struct
import threading
import time

import pytest

from ceph_tpu_torch.auth import (
    AuthError,
    CephxClient,
    CephxServer,
    Keyring,
    Ticket,
    seal,
    unseal,
    verify_authorizer,
)
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.core.encoding import Encoder
from ceph_tpu_torch.msg.message import EntityName, Message, register
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger

WAIT_S = 10.0


# -- crypto / protocol units ------------------------------------------------

def test_seal_unseal_roundtrip_and_tamper():
    key = b"k" * 32
    blob = seal(key, b"secret payload")
    assert unseal(key, blob) == b"secret payload"
    with pytest.raises(AuthError):
        unseal(key, blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(AuthError):
        unseal(b"x" * 32, blob)


def _handshake(server, name, secret):
    cx = CephxClient(name, secret)
    ch = server.get_challenge(name)
    cc = secrets.token_bytes(16)
    sealed, ticket = server.handle_request(
        name, cc, cx.make_proof(ch, cc))
    cx.accept_reply(sealed, ticket)
    return cx


def test_handshake_and_authorizer():
    kr = Keyring()
    kr.add("service")
    secret = kr.add("client.1")
    server = CephxServer(kr)
    cx = _handshake(server, "client.1", secret)
    assert cx.authenticated
    ticket = verify_authorizer(server.service_secret,
                               cx.build_authorizer())
    assert ticket.name == "client.1"
    assert cx.session_key == ticket.session_key


def test_wrong_secret_rejected():
    kr = Keyring()
    kr.add("service")
    kr.add("client.1")
    server = CephxServer(kr)
    with pytest.raises(AuthError):
        _handshake(server, "client.1", b"wrong" * 8)
    with pytest.raises(AuthError):
        _handshake(server, "client.ghost", b"x" * 32)


def test_expired_ticket_rejected():
    kr = Keyring()
    kr.add("service")
    secret = kr.add("client.1")
    server = CephxServer(kr)
    cx = _handshake(server, "client.1", secret)
    blob = cx.build_authorizer()
    with pytest.raises(AuthError):
        verify_authorizer(server.service_secret, blob,
                          now=time.time() + 7200)


def test_forged_ticket_rejected():
    kr = Keyring()
    kr.add("service")
    secret = kr.add("client.1")
    server = CephxServer(kr)
    _handshake(server, "client.1", secret)
    # a client who knows only its OWN secret cannot mint tickets
    fake = Ticket("client.evil", "allow *", b"s" * 32, time.time() + 600)
    forged = seal(secret, fake.encode())  # sealed with the WRONG key
    e = Encoder()
    e.start(1, 1)
    stamp = time.time()
    e.blob(forged).f64(stamp)
    e.blob(hmac.new(b"s" * 32, b"authorizer" + struct.pack("<d", stamp),
                    hashlib.sha256).digest())
    e.finish()
    with pytest.raises(AuthError):
        verify_authorizer(server.service_secret, e.bytes())


def test_keyring_file_roundtrip(tmp_path):
    kr = Keyring()
    kr.add("mon.")
    kr.add("osd.0")
    kr.add("client.admin")
    p = str(tmp_path / "keyring")
    kr.save(p)
    kr2 = Keyring.load(p)
    assert kr2.names() == kr.names()
    for n in kr.names():
        assert kr2.get(n) == kr.get(n)


# -- messenger session gating ------------------------------------------------

@register
class _MPing(Message):
    TYPE = 99


class _Sink(Dispatcher):
    def __init__(self):
        self.got = []
        self.cond = threading.Condition()

    def ms_dispatch(self, conn, msg):
        with self.cond:
            self.got.append(msg)
            self.cond.notify_all()
        return True


def test_messenger_rejects_unauthenticated_sessions():
    kr = Keyring()
    kr.add("service")
    secret = kr.add("client.7")
    server = CephxServer(kr)
    cx = _handshake(server, "client.7", secret)

    ctx = Context("authtest")
    sink = _Sink()
    acceptor = Messenger(ctx, EntityName("osd", 0))
    acceptor.add_dispatcher(sink)
    verdicts = []
    cond = threading.Condition()

    def _verify(blob):
        try:
            verify_authorizer(server.service_secret, blob)
            ok = True
        except Exception:
            ok = False
        with cond:
            verdicts.append(ok)
            cond.notify_all()
        return ok

    acceptor.set_auth(verifier=_verify)
    acceptor.start()

    good = Messenger(ctx, EntityName("client", 7))
    good.set_auth(provider=cx.build_authorizer)
    good.start()
    bad = Messenger(ctx, EntityName("client", 666))
    bad.start()  # no authorizer at all
    try:
        good.send_message(_MPing(), acceptor.addr)
        with sink.cond:
            assert sink.cond.wait_for(lambda: sink.got, WAIT_S), \
                "authenticated session was not delivered"
        n_before = len(sink.got)
        bad.send_message(_MPing(), acceptor.addr)
        # the dialer keeps redialing its lossless session: two refused
        # announces mean the frame behind the first was never read
        with cond:
            assert cond.wait_for(
                lambda: verdicts.count(False) >= 2, WAIT_S)
        assert len(sink.got) == n_before, \
            "unauthenticated session delivered a message"
        assert all(m.src == EntityName("client", 7) for m in sink.got)
    finally:
        good.shutdown()
        bad.shutdown()
        acceptor.shutdown()


# -- authenticated cluster ----------------------------------------------------

def test_authenticated_cluster_io():
    """The mon issues tickets; the daemons require authorizers; an
    authenticated client does IO while a wrong-key client cannot even
    authenticate."""
    import socket

    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool, POOL_REPLICATED
    from ceph_tpu_torch.store.memstore import MemStore

    kr = Keyring()
    kr.add("service")
    for i in range(3):
        kr.add(f"osd.{i}")
    admin_secret = kr.add("client.admin")

    cm, root = cmap.build_flat_cluster(3, hosts=3)
    cm.add_simple_rule("r", root, 1, mode="firstn")
    seed = OSDMap(cm, max_osd=3, device="cpu")
    seed.osd_state_up[:] = False
    seed.add_pool(PGPool(1, POOL_REPLICATED, size=2, min_size=1,
                         pg_num=4, pgp_num=4, crush_rule=0))

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = Context("authcluster", {"mon_tick_interval": 0.3})
    monmap = MonMap([("127.0.0.1", port)])
    mon = Monitor(ctx, 0, monmap, initial_map=seed, bind_port=port,
                  keyring=kr, device="cpu")
    mon.start()
    osds = []
    cl = None
    try:
        for i in range(3):
            svc = OSDService(ctx, i, MemStore(), None,
                             codec_from_profile, device="cpu")
            svc.store.mkfs()
            svc.init()
            svc.boot(monmap, keyring=kr)
            osds.append(svc)
        deadline = time.time() + 20
        while time.time() < deadline:
            if mon.osdmap is not None and all(
                    mon.osdmap.is_up(i) for i in range(3)):
                break
            time.sleep(0.2)
        assert all(mon.osdmap.is_up(i) for i in range(3)), "osds not up"

        cl = RadosClient(ctx, device="cpu").connect(
            monmap, auth=("client.admin", admin_secret))
        io = cl.ioctx(1)
        io.write_full("authobj", b"authenticated!" * 50)
        assert io.read("authobj") == b"authenticated!" * 50

        # wrong key: the mon refuses the handshake outright
        with pytest.raises(AuthError):
            RadosClient(ctx, device="cpu").connect(
                monmap, auth=("client.admin", b"bad" * 8))
    finally:
        if cl is not None:
            cl.shutdown()
        for o in osds:
            o.shutdown()
        mon.shutdown()


def test_authorizer_replay_and_target_binding():
    """A captured authorizer cannot be replayed (seen-cache) or pointed
    at a different daemon (target binding)."""
    kr = Keyring()
    kr.add("service")
    secret = kr.add("client.9")
    server = CephxServer(kr)
    cx = _handshake(server, "client.9", secret)

    blob = cx.build_authorizer(target="127.0.0.1:6800")
    seen = {}
    t = verify_authorizer(server.service_secret, blob,
                          expect_target="127.0.0.1:6800", seen=seen)
    assert t.name == "client.9"
    with pytest.raises(AuthError):
        verify_authorizer(server.service_secret, blob,
                          expect_target="127.0.0.1:6800", seen=seen)
    blob2 = cx.build_authorizer(target="127.0.0.1:6800")
    with pytest.raises(AuthError):
        verify_authorizer(server.service_secret, blob2,
                          expect_target="127.0.0.1:6801", seen={})
    blob3 = cx.build_authorizer(target="127.0.0.1:6800")
    verify_authorizer(server.service_secret, blob3,
                      expect_target="127.0.0.1:6800", seen=seen)
