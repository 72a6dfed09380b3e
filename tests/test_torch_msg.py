"""The port's messenger (``ceph_tpu_torch/msg/``), case for case against
``tests/test_msg.py`` (all 10 cases): roundtrip, ordering,
reply-over-session, reconnect resend, duplicate suppression, the lossy
and stateless policies.  Every socket binds to 127.0.0.1, and every
wait is on a condition with a deadline: where the reference sleeps
before a negative check, these cases wait for the event that makes the
check meaningful (a marker sent after the duplicate arrives, the
replayed frame's re-ack lands).  The port's loop-stall record is held
empty after each case, as the reference's conftest holds its own.
"""

import struct
import threading
import time

import pytest

from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.msg import messenger as msgr_mod
from ceph_tpu_torch.msg.message import EntityName, Message, register
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger, Policy

WAIT_S = 10.0


def wait_until(pred, timeout: float = WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@register
class MEcho(Message):
    TYPE = 9001

    def __init__(self, text: str = "") -> None:
        super().__init__()
        self.text = text

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.text)

    def decode_payload(self, d: Decoder) -> None:
        self.text = d.string()


@register
class MEchoReply(Message):
    TYPE = 9002

    def __init__(self, text: str = "") -> None:
        super().__init__()
        self.text = text

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.text)

    def decode_payload(self, d: Decoder) -> None:
        self.text = d.string()


class Collector(Dispatcher):
    def __init__(self, reply: bool = False) -> None:
        self.got = []
        self.resets = []
        self.reply = reply
        self.cond = threading.Condition()

    def ms_dispatch(self, conn, msg) -> bool:
        with self.cond:
            self.got.append(msg)
            self.cond.notify_all()
        if self.reply and isinstance(msg, MEcho):
            conn.send(MEchoReply(msg.text.upper()))
        return True

    def ms_handle_reset(self, conn) -> None:
        with self.cond:
            self.resets.append(conn)
            self.cond.notify_all()

    def wait_for(self, n: int, timeout: float = WAIT_S) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: len(self.got) >= n, timeout)

    def wait_for_text(self, text: str, timeout: float = WAIT_S) -> bool:
        with self.cond:
            return self.cond.wait_for(
                lambda: any(getattr(m, "text", None) == text
                            for m in self.got),
                timeout,
            )

    def texts(self):
        with self.cond:
            return [getattr(m, "text", None) for m in self.got]


@pytest.fixture(autouse=True)
def _no_loop_stalls():
    msgr_mod.LOOP_STALLS.clear()
    yield
    stalls, msgr_mod.LOOP_STALLS[:] = list(msgr_mod.LOOP_STALLS), []
    assert not stalls, f"fast dispatch blocked the event loop: {stalls}"


@pytest.fixture
def ctx():
    return Context("client.1")


def _mk(ctx, name):
    m = Messenger(ctx, EntityName.parse(name))
    m.start()
    return m


def test_message_registry_roundtrip():
    m = MEcho("hello")
    m.tid = 42
    m.src = EntityName("osd", 3)
    m2 = Message.from_bytes(m.to_bytes())
    assert isinstance(m2, MEcho)
    assert m2.text == "hello" and m2.tid == 42
    assert m2.src == EntityName("osd", 3)


def test_send_and_dispatch(ctx):
    a = _mk(ctx, "client.1")
    b = _mk(ctx, "osd.0")
    coll = Collector()
    b.add_dispatcher(coll)
    try:
        assert a.addr[0] == b.addr[0] == "127.0.0.1"
        for i in range(10):
            a.send_message(MEcho(f"m{i}"), b.addr)
        assert coll.wait_for(10)
        assert coll.texts() == [f"m{i}" for i in range(10)]  # ordered
        assert coll.got[0].src == EntityName("client", 1)
    finally:
        a.shutdown()
        b.shutdown()


def test_reply_over_same_session(ctx):
    a = _mk(ctx, "client.1")
    b = _mk(ctx, "osd.0")
    server = Collector(reply=True)
    client = Collector()
    b.add_dispatcher(server)
    a.add_dispatcher(client)
    try:
        conn = a.connect(b.addr)
        conn.send(MEcho("ping"))
        assert client.wait_for(1)
        assert isinstance(client.got[0], MEchoReply)
        assert client.got[0].text == "PING"
    finally:
        a.shutdown()
        b.shutdown()


def test_reconnect_resends_unacked(ctx):
    """Lossless-peer: kill the receiver, restart on the same port, and
    unacked messages must be replayed."""
    a = _mk(ctx, "osd.1")
    b = _mk(ctx, "osd.2")
    coll = Collector()
    b.add_dispatcher(coll)
    addr = b.addr
    try:
        a.send_message(MEcho("before"), addr)
        assert coll.wait_for(1)
        b.shutdown()  # peer dies with the session open

        conn = a.connect(addr)
        a.send_message(MEcho("while-down"), addr)  # queued + unacked
        assert wait_until(lambda: conn.out_seq == 2
                          and any(s == 2 for s, _ in conn._unacked))

        b2 = Messenger(ctx, EntityName.parse("osd.2"),
                       bind_ip=addr[0], bind_port=addr[1])
        coll2 = Collector()
        b2.add_dispatcher(coll2)
        b2.start()
        try:
            # the queued 'while-down' (and the 'before' if its ack was
            # lost) must arrive, in session order
            assert coll2.wait_for_text("while-down", timeout=15)
        finally:
            b2.shutdown()
    finally:
        a.shutdown()


def test_duplicate_suppression_after_replay(ctx):
    """Replayed frames the peer already dispatched must be dropped by
    the session's dispatched seq (at-most-once dispatch per seq)."""
    a = _mk(ctx, "osd.1")
    b = _mk(ctx, "osd.2")
    coll = Collector()
    b.add_dispatcher(coll)
    try:
        conn = a.connect(b.addr)
        conn.send(MEcho("x"))
        assert coll.wait_for(1)
        assert a.connect(b.addr) is conn
        m = MEcho("x")

        def resend_same_seq():
            conn.out_seq -= 1  # reuses the seq just sent
            conn._enqueue(m)

        a._loop.call_soon_threadsafe(resend_same_seq)
        # the session is ordered: once a later marker is dispatched,
        # the duplicate before it has been seen and dropped
        conn.send(MEcho("marker"))
        assert coll.wait_for_text("marker")
        assert coll.texts() == ["x", "marker"]
    finally:
        a.shutdown()
        b.shutdown()


class HoldingServer(Dispatcher):
    """Stores the request's connection; replies only when told to."""

    def __init__(self) -> None:
        self.conns = []
        self.event = threading.Event()

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MEcho):
            self.conns.append(conn)
            self.event.set()
            return True
        return False


def test_reply_survives_socket_death(ctx):
    """Lossless in BOTH directions: a reply queued after the socket died
    is delivered when the dialer reconnects the same session."""
    a = _mk(ctx, "client.9")
    b = _mk(ctx, "osd.9")
    server = HoldingServer()
    client = Collector()
    b.add_dispatcher(server)
    a.add_dispatcher(client)
    try:
        conn = a.connect(b.addr)
        conn.send(MEcho("req"))
        assert server.event.wait(WAIT_S)
        srv_conn = server.conns[0]

        def kill():
            if conn._writer:
                conn._writer.close()

        a._loop.call_soon_threadsafe(kill)
        # the accepted side has seen the socket die
        assert wait_until(lambda: srv_conn._writer is None)
        srv_conn.send(MEchoReply("LATE"))
        assert client.wait_for_text("LATE", timeout=15)
    finally:
        a.shutdown()
        b.shutdown()


def test_dup_suppression_across_reconnect(ctx):
    """A replayed frame already dispatched before the session dropped
    must NOT dispatch twice on the new socket."""
    a = _mk(ctx, "osd.3")
    b = _mk(ctx, "osd.4")
    coll = Collector()
    b.add_dispatcher(coll)
    try:
        conn = a.connect(b.addr)
        conn.send(MEcho("only-once"))
        assert coll.wait_for_text("only-once")
        m = MEcho("only-once")
        m.seq = 1
        m.nonce = a.nonce
        m.sid = conn.sid
        m.src = a.entity
        body = m.to_bytes()
        frame = struct.pack("<II", len(body), crc32c(body)) + body
        replayed = threading.Event()

        def forge():
            conn.acked = 0
            conn._unacked = [(1, frame)]
            if conn._writer:
                conn._writer.close()  # triggers reconnect + replay
            replayed.set()

        a._loop.call_soon_threadsafe(forge)
        assert replayed.wait(WAIT_S)
        # the acceptor re-acks the replayed seq, which trims it
        assert wait_until(lambda: conn.acked == 1 and not conn._unacked)
        conn.send(MEcho("after"))
        assert coll.wait_for_text("after")
        assert coll.texts().count("only-once") == 1
    finally:
        a.shutdown()
        b.shutdown()


def test_lossy_client_policy_drops_on_reset(ctx):
    """Policy.lossy_client: the session dies with the socket — no
    reconnect, no replay; the dispatcher sees a reset."""
    a = _mk(ctx, "client.7")
    a.set_policy("osd", Policy.lossy_client())
    b = _mk(ctx, "osd.0")
    server = Collector()
    client = Collector()
    b.add_dispatcher(server)
    a.add_dispatcher(client)
    try:
        conn = a.connect(b.addr, peer_type="osd")
        assert conn.policy.lossy
        conn.send(MEcho("before"))
        assert server.wait_for(1)
        port = b.addr[1]
        b.shutdown()
        conn.send(MEcho("lost"))
        assert wait_until(lambda: conn._closed), \
            "lossy session must die with the socket"
        assert conn._unacked == []
        assert client.resets, "dispatcher must hear ms_handle_reset"
        b2 = Messenger(ctx, EntityName.parse("osd.0"), bind_port=port)
        b2.start()
        server2 = Collector()
        b2.add_dispatcher(server2)
        try:
            conn2 = a.connect(b.addr, peer_type="osd")
            assert conn2 is not conn
            conn2.send(MEcho("fresh"))
            assert server2.wait_for_text("fresh")
            assert "lost" not in server2.texts()
        finally:
            b2.shutdown()
    finally:
        a.shutdown()


def test_stateless_server_policy_forgets_sessions(ctx):
    """Policy.stateless_server: an accepted lossy session is never
    retained for replay across sockets."""
    a = _mk(ctx, "client.9")
    b = _mk(ctx, "osd.3")
    b.set_policy("client", Policy.stateless_server())
    server = Collector(reply=True)
    b.add_dispatcher(server)
    client = Collector()
    a.add_dispatcher(client)
    try:
        conn = a.connect(b.addr)
        conn.send(MEcho("hi"))
        assert client.wait_for(1)  # reply arrived over the same socket
        assert b._accepted_sessions == {}  # nothing retained
    finally:
        a.shutdown()
        b.shutdown()


def test_default_policy_unchanged_lossless(ctx):
    m = _mk(ctx, "osd.5")
    try:
        assert not m.get_policy("anything").lossy
        m.set_default_policy(Policy.lossy_client())
        assert m.get_policy("osd").lossy
        m.set_policy("mon", Policy.lossless_peer())
        assert not m.get_policy("mon").lossy
    finally:
        m.shutdown()
