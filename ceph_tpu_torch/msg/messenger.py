"""Async messenger: ordered, lossless, reconnecting TCP sessions.

Reference: AsyncMessenger (src/msg/async/) — an event loop owning all
connections, with session policies and throttle-based flow control:

- ordered delivery per session (header.seq; duplicates after reconnect
  are dropped by in_seq, the AsyncConnection resend discipline)
- lossless-peer policy: unacked messages are replayed on reconnect
  (acks piggyback on reverse traffic, MAck otherwise)
- dispatch throttle: ms_dispatch_throttle_bytes of queued undispatched
  bytes apply backpressure to the socket (reference policy throttles,
  src/msg/Policy.h)
- fast-dispatch analog: dispatchers run on a per-connection ordered
  task, so one slow peer never stalls others

One asyncio loop runs in a background thread per Messenger; public
send/stop APIs are thread-safe, so daemon code stays synchronous.

Port of ``ceph_tpu/msg/messenger.py``, name for name.  The frames are
the reference's byte for byte, so the two packages' messengers talk to
each other.  Its locks come from the port's lockdep (``msgr.xq``,
``msgr.conns``), its loop's crash handler from ``core.crash``, and its
frame CRC is the host ``core.crc`` over a view of the frame buffer.
A payload is host bytes (bytes, bytearray, memoryview or a flat uint8
ndarray) or a ``gpu.staging.DeviceBuf``, which ``Encoder.blob`` reads
through its counted ``wire_view`` as the frame is built.  Its blocking
dispatch runs on a thread pool of its own (the reference's runs on the
loop's default executor), which ``shutdown`` releases, so a stopped
messenger leaves no idle thread behind.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.encoding import Encoder
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.msg.message import MAck, Message

_FRAME = struct.Struct("<II")  # body_len, crc32c(body)

Addr = Tuple[str, int]

# loop-stall sanitizer record: (entity, message type, seconds).  A
# fast-dispatched handler that blocks past ms_loop_stall_ms lands
# here; the tier-1 conftest fails the test that produced it.  The
# reference analog is the suicide-grace heartbeat on dispatch threads
# (HeartbeatMap) — here the asset being guarded is the event loop that
# must keep reading every peer's replies.
LOOP_STALLS: List[Tuple[str, str, float]] = []


class Dispatcher:
    """Reference src/msg/Dispatcher.h."""

    def ms_can_fast_dispatch(self, msg: Message) -> bool:
        """True = this message may dispatch INLINE on the messenger's
        event loop (the reference ms_fast_dispatch): only for handlers
        that never block — no store work, no lock waits, no RPCs."""
        return False

    def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        """Return True if handled; first dispatcher to claim it wins."""
        raise NotImplementedError

    def ms_handle_reset(self, conn: "Connection") -> None:
        """Session dropped and could not be restored."""


class Policy:
    """Session policy (reference src/msg/Policy.h).

    - lossless_peer: never give up — unacked messages replay across
      reconnects in both directions (osd<->osd, mon<->mon).  This is
      the messenger's default and the behavior every daemon relies on.
    - lossy client/server: the session dies with the socket.  No
      reconnect, no replay; the higher layer owns retries (the
      reference's client->osd sessions, where the Objecter resends by
      epoch).  On the server, a lossy peer's session state is dropped
      the moment its socket dies.
    """

    def __init__(self, lossy: bool = False, server: bool = False) -> None:
        self.lossy = lossy
        self.server = server

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False, server=False)

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True, server=False)

    @classmethod
    def stateless_server(cls) -> "Policy":
        """Serving lossy clients: forget their sessions on disconnect."""
        return cls(lossy=True, server=True)

    def __repr__(self) -> str:
        return f"Policy(lossy={self.lossy}, server={self.server})"


class Connection:
    """One ordered session to a peer address."""

    def __init__(self, msgr: "Messenger", addr: Addr,
                 policy: Optional["Policy"] = None) -> None:
        import random

        self.msgr = msgr
        self.peer_addr = addr
        self.policy = policy or Policy.lossless_peer()
        self.sid = random.getrandbits(63) | 1  # this session's seq space
        # per-connection dispatch-gate state (set_dispatch_gate): in-
        # flight ops/bytes granted to this peer's session, and the
        # loop-owned event gate waiters park on.  Counters mutate ONLY
        # on the event loop (releases hop via call_soon_threadsafe).
        self._gate_ops = 0
        self._gate_bytes = 0
        self._gate_evt: Optional[asyncio.Event] = None
        self.out_seq = 0
        self.in_seq = 0
        self.acked = 0
        # ack coalescing: highest in_seq this side has COMMUNICATED to
        # the peer (piggybacked on an outgoing frame or flushed as a
        # dedicated MAck); a pending flush timer dedups dedicated acks
        self._ack_sent = 0
        self._ack_timer = None
        self._unacked: List[Tuple[int, bytes]] = []  # (seq, frame)
        self._writer: Optional[asyncio.StreamWriter] = None
        self._send_q: asyncio.Queue = asyncio.Queue()
        self._pump_task: Optional[asyncio.Task] = None  # accepted side
        self._closed = False

    # -- sender side ------------------------------------------------------
    def send(self, msg: Message) -> None:
        """Thread-safe enqueue; ordering = call order."""
        self.msgr._cross_send(self, msg)

    def _enqueue(self, msg: Message) -> None:
        if self._closed:
            return
        self.out_seq += 1
        msg.seq = self.out_seq
        msg.ack_seq = self.in_seq  # piggyback
        if self.in_seq > self._ack_sent:
            # this frame carries the ack: the deferred dedicated-ack
            # flush (if armed) will see nothing left to say
            self._ack_sent = self.in_seq
        msg.nonce = self.msgr.nonce
        msg.sid = self.sid
        if msg.src is None:
            msg.src = self.msgr.entity
        frame = self.msgr._frame_of(msg)
        if not self.policy.lossy:
            # lossy sessions never replay, so nothing to retain
            self._unacked.append((msg.seq, frame))
        self._send_q.put_nowait(frame)

    def _handle_ack(self, ack_seq: int) -> None:
        if ack_seq > self.acked:
            self.acked = ack_seq
            self._unacked = [(s, f) for s, f in self._unacked if s > ack_seq]

    def close(self) -> None:
        self.msgr._loop_call(self._close)

    def _close(self) -> None:
        self._closed = True
        if self._ack_timer is not None:
            self._ack_timer.cancel()  # no acks into a dead send queue
            self._ack_timer = None
        if self._writer is not None:
            try:
                self._writer.close()
            except (OSError, RuntimeError):
                pass  # dead transport / loop already closed
        self._send_q.put_nowait(None)  # wake the writer task

    def __repr__(self) -> str:
        return f"Connection(to={self.peer_addr})"


class Messenger:
    def __init__(
        self,
        ctx,
        entity,
        bind_ip: str = "127.0.0.1",
        bind_port: int = 0,
    ) -> None:
        self.ctx = ctx
        self.entity = entity
        # incarnation nonce: dup-suppression state on peers is keyed by
        # (src entity, nonce) so a restarted messenger starts a fresh
        # seq space (reference: entity_addr_t nonce)
        import random

        self.nonce = random.getrandbits(63) | 1
        self.crc_data = bool(ctx.conf.get("ms_crc_data")) if ctx else True
        self._retry = ctx.conf.get("ms_retry_interval") if ctx else 0.2
        self._dispatchers: List[Dispatcher] = []
        self._conns: Dict[Addr, Connection] = {}
        self._loop = asyncio.new_event_loop()
        # the threads that run blocking dispatch (asyncio.to_thread) are
        # this messenger's own, so shutdown() can let them go
        self._dispatch_pool = concurrent.futures.ThreadPoolExecutor(
            thread_name_prefix=f"msgr-{entity}-dispatch")
        self._loop.set_default_executor(self._dispatch_pool)
        # event-loop deaths leave a crash report in every installed
        # CrashArchive (before this, only daemon THREAD deaths did)
        from ceph_tpu_torch.core.crash import install_loop_handler

        install_loop_handler(self._loop)
        self._thread = threading.Thread(
            target=self._loop.run_forever, name=f"msgr-{entity}", daemon=True
        )
        # cross-thread send staging: N sends from commit/worker threads
        # collapse into ONE loop wakeup (call_soon_threadsafe writes the
        # self-pipe per call — per-message wakeups dominated the op
        # path's CPU profile before this)
        import collections

        self._xq: "collections.deque" = collections.deque()
        self._xq_lock = make_lock("msgr.xq")
        self._xq_armed = False
        self._server: Optional[asyncio.base_events.Server] = None
        self.addr: Optional[Addr] = None
        self._bind = (bind_ip, bind_port)
        self._stopped = False
        throttle_bytes = (
            ctx.conf.get("ms_dispatch_throttle_bytes") if ctx else 100 << 20
        )
        self._dispatch_budget = throttle_bytes
        self._budget_free: Optional[asyncio.Event] = None  # made on loop
        self._conn_lock = make_lock("msgr.conns")
        self._accepted: set = set()  # live accepted-side connections
        # per-session cumulative dispatch seq, shared across the sockets
        # of one logical session so replays after reconnect are
        # suppressed (the reference's in_seq survives in the Connection
        # found by peer addr; here the accepted socket is recreated, so
        # the state lives on the messenger keyed by src ->
        # (incarnation nonce, {session sid: seq})).  A new nonce from a
        # src supersedes — and prunes — the old incarnation's state;
        # sids within an incarnation are capped LRU-style
        self._peer_in_seq: Dict[str, Tuple[int, Dict[int, int]]] = {}
        self._max_sids_per_peer = 64
        # accepted-side sessions keyed by the dialer's (src, nonce, sid):
        # the lossless guarantee must hold in BOTH directions, so replies
        # queued on an accepted Connection survive socket death and are
        # replayed when the dialer reconnects the same logical session
        # (the reference's lossless-peer resend discipline)
        self._accepted_sessions: Dict[Tuple[str, int, int], Connection] = {}
        self._max_accepted_sessions = 256
        # cephx hooks: provider() -> authorizer bytes attached to every
        # session announce; verifier(blob) -> bool gates every accepted
        # socket (reference: authorizer in the connect negotiation)
        self._auth_provider = None
        self._auth_verifier = None
        # session policies keyed by peer entity type ("mon"/"osd"/
        # "client"/...); unset types use the default (reference:
        # Messenger::set_policy / set_default_policy, src/msg/Policy.h)
        self._policies: Dict[str, Policy] = {}
        self._default_policy = Policy.lossless_peer()
        self._log = ctx.log.dout("ms") if ctx else (lambda lvl, s: None)
        # deferred dedicated acks: hold each dispatch ack this long
        # hoping an outgoing data frame piggybacks it first
        self._ack_delay = (ctx.conf.get("ms_ack_delay") if ctx else 0.002)
        # loop-stall sanitizer: wall-time budget for an INLINE
        # (fast-dispatch) handler.  0 = off (production default); the
        # test conftest arms it via CEPH_TPU_LOOP_STALL_MS so a
        # blocking handler fails the test that introduced it.
        stall_ms = os.environ.get("CEPH_TPU_LOOP_STALL_MS")
        if stall_ms is None and ctx is not None:
            stall_ms = ctx.conf.get("ms_loop_stall_ms")
        try:
            self._stall_s = float(stall_ms or 0) / 1000.0
        except ValueError:
            self._stall_s = 0.0
        # per-connection dispatch gate (set_dispatch_gate): the
        # reference client-messenger Throttle pair — None = disabled
        self._gate = None
        self.perf = None
        if ctx is not None:
            pc = ctx.perf.create(f"msgr.{entity}")
            pc.add_histogram("frames_per_drain",
                             "frames coalesced into one socket write")
            pc.add_u64_counter("acks_dedicated",
                               "dedicated MAck frames sent")
            pc.add_u64_counter("acks_piggybacked",
                               "dispatch acks that rode outgoing data")
            pc.add_u64_counter("loop_stalls",
                               "fast-dispatch handlers that blocked the "
                               "event loop past ms_loop_stall_ms")
            pc.add_u64_counter("throttle_stall",
                               "dispatch-gate waits: a peer connection "
                               "stopped reading because its in-flight "
                               "op/byte cap was full")
            pc.add_histogram("throttle_stall_us",
                             "dispatch-gate wait durations (us)")
            self.perf = pc

    def set_policy(self, peer_type: str, policy: Policy) -> None:
        self._policies[peer_type] = policy

    def set_default_policy(self, policy: Policy) -> None:
        self._default_policy = policy

    def get_policy(self, peer_type: Optional[str]) -> Policy:
        if peer_type is None:
            return self._default_policy
        return self._policies.get(peer_type, self._default_policy)

    def set_auth(self, provider=None, verifier=None) -> None:
        """provider() -> bytes | None; verifier(blob) -> bool."""
        if provider is not None:
            self._auth_provider = provider
        if verifier is not None:
            self._auth_verifier = verifier

    # -- per-connection dispatch gate (edge backpressure) -----------------
    def set_dispatch_gate(self, cost_fn, msg_cap: int,
                          size_cap: int) -> None:
        """Per-connection in-flight op/byte throttle (the reference
        client-messenger Throttle pair, osd_client_message_cap /
        _size_cap).  ``cost_fn(msg) -> payload bytes`` for messages
        subject to the gate, ``None`` for exempt ones.  While a
        connection is over either cap, ITS frame reader awaits — the
        socket stops being read and TCP backpressures the abusive
        peer; every other connection keeps flowing.  The grant rides
        the message as ``msg._gate_release`` (idempotent, thread-safe)
        and the daemon's reply path releases it.  Re-call to retune
        the caps at runtime (conf observer)."""
        self._gate = (cost_fn, int(msg_cap), int(size_cap))

    def _gate_over(self, conn: Connection, nbytes: int, cap: int,
                   szcap: int) -> bool:
        if cap > 0 and conn._gate_ops >= cap:
            return True
        # an oversized single message through an idle gate still
        # passes (the Throttle one-oversized-request discipline)
        return (szcap > 0 and conn._gate_bytes > 0
                and conn._gate_bytes + nbytes > szcap)

    async def _gate_acquire(self, conn: Connection, nbytes: int) -> bool:
        """Take one op + `nbytes` of gate budget on `conn`; True when
        the acquire had to stall (throttle_stall evidence)."""
        stalled = False
        t0 = None
        while True:
            gate = self._gate
            if gate is None:
                break
            _fn, cap, szcap = gate
            if not self._gate_over(conn, nbytes, cap, szcap):
                break
            if not stalled:
                stalled = True
                t0 = time.perf_counter()
                if self.perf is not None:
                    self.perf.inc("throttle_stall")
            if conn._gate_evt is None:
                conn._gate_evt = asyncio.Event()
            conn._gate_evt.clear()
            await conn._gate_evt.wait()
        conn._gate_ops += 1
        conn._gate_bytes += nbytes
        if stalled and self.perf is not None:
            self.perf.hinc("throttle_stall_us",
                           (time.perf_counter() - t0) * 1e6)
        return stalled

    def _gate_release_fn(self, conn: Connection, nbytes: int):
        """Idempotent, thread-safe release of one gate grant."""
        done = [False]

        def release() -> None:
            if done[0]:
                return
            done[0] = True

            def on_loop() -> None:
                conn._gate_ops = max(0, conn._gate_ops - 1)
                conn._gate_bytes = max(0, conn._gate_bytes - nbytes)
                if conn._gate_evt is not None:
                    conn._gate_evt.set()

            try:
                self._loop.call_soon_threadsafe(on_loop)
            except RuntimeError:
                pass  # loop already closed (messenger shutdown)

        return release

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._start_server(), self._loop)
        fut.result(timeout=10)

    async def _start_server(self) -> None:
        self._server = await asyncio.start_server(
            self._on_accept, self._bind[0], self._bind[1]
        )
        sock = self._server.sockets[0]
        self.addr = sock.getsockname()[:2]

    def shutdown(self) -> None:
        if self._stopped:
            return
        self._stopped = True

        async def _stop():
            for c in list(self._conns.values()):
                c._close()
            for c in list(self._accepted):
                c._close()
            for c in list(self._accepted_sessions.values()):
                c._close()
            if self._server is not None:
                self._server.close()
                # NO wait_closed(): since 3.12 it waits for every
                # accepted-connection HANDLER to finish, and handlers
                # blocked in reads only exit via the cancel sweep below
                # — awaiting first deadlocks the shutdown
            # cancel and await every task this messenger spawned
            # (reconnect sleepers, send-queue waiters, frame readers):
            # abandoning them leaks "Task was destroyed but it is
            # pending!" warnings at interpreter exit and can mask real
            # shutdown bugs.  Each messenger owns its loop+thread, so
            # all_tasks() here is exactly our own task set.
            me = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not me]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(_stop(), self._loop).result(timeout=10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        # idle dispatch threads exit now, a busy one when its handler
        # returns (without waiting here: a handler may be blocked on an
        # RPC whose replies this shutdown just cut off)
        self._dispatch_pool.shutdown(wait=False)

    def add_dispatcher(self, d: Dispatcher) -> None:
        self._dispatchers.append(d)

    # -- connection management -------------------------------------------
    def connect(self, addr: Addr,
                peer_type: Optional[str] = None) -> Connection:
        addr = (addr[0], addr[1])
        with self._conn_lock:
            conn = self._conns.get(addr)
            if conn is None or conn._closed:
                conn = Connection(self, addr,
                                  policy=self.get_policy(peer_type))
                self._conns[addr] = conn
                self._loop_call(self._spawn_outgoing, conn)
            elif (peer_type is not None
                  and conn.policy.lossy != self.get_policy(peer_type).lossy):
                # an existing live session keeps its policy; surface the
                # mismatch rather than silently handing back the other
                # caller's semantics
                self._log(1, f"connect({addr}, {peer_type}): reusing live "
                             f"session with {conn.policy!r}")
            return conn

    def send_message(self, msg: Message, addr: Addr) -> None:
        self.connect(addr).send(msg)

    def _loop_call(self, fn, *args) -> None:
        self._loop.call_soon_threadsafe(fn, *args)

    def _cross_send(self, conn: Connection, msg: Message) -> None:
        """Stage a send for the loop; arm at most ONE wakeup for any
        number of staged messages.  Sends issued FROM the loop thread
        (fast-dispatch replies) enqueue directly — no self-pipe at
        all."""
        if threading.current_thread() is self._thread:
            conn._enqueue(msg)
            return
        with self._xq_lock:
            self._xq.append((conn, msg))
            if self._xq_armed:
                return
            self._xq_armed = True
        self._loop.call_soon_threadsafe(self._drain_cross_sends)

    def _drain_cross_sends(self) -> None:
        while True:
            # staging-deque leaf lock: both sides hold it for an
            # append/swap only, so the loop never blocks on it
            with self._xq_lock:
                if not self._xq:
                    self._xq_armed = False
                    return
                items = list(self._xq)
                self._xq.clear()
            for conn, msg in items:
                conn._enqueue(msg)

    def _spawn_outgoing(self, conn: Connection) -> None:
        self._loop.create_task(self._run_outgoing(conn))

    async def _run_outgoing(self, conn: Connection) -> None:
        """Dial, replay unacked, then pump frames; reconnect on error."""
        while not conn._closed and not self._stopped:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*conn.peer_addr), timeout=10
                )
            except (OSError, asyncio.TimeoutError):
                if conn.policy.lossy:
                    break  # lossy teardown below: no dial retries either
                await asyncio.sleep(self._retry)
                continue
            # guard against TCP self-connect: dialing a dead localhost
            # port can land on our own ephemeral source port and
            # "succeed" against ourselves, wedging reconnect forever.
            # A connection that died between connect and here reports
            # None addresses — treat as a failed dial, not a crash of
            # the whole outgoing task (thrash-kill window)
            sockname = writer.get_extra_info("sockname")
            peername = writer.get_extra_info("peername")
            if sockname is None or peername is None:
                writer.close()
                await asyncio.sleep(self._retry)
                continue
            if sockname[:2] == peername[:2]:
                writer.close()
                await asyncio.sleep(self._retry)
                continue
            conn._writer = writer
            # announce the session (src, nonce, sid) first so the
            # acceptor can reattach its persistent session state even
            # when we have nothing to send — e.g. a reconnect whose only
            # purpose is collecting replies queued on the other side
            announce = MAck()
            announce.src = self.entity
            announce.nonce = self.nonce
            announce.sid = conn.sid
            announce.ack_seq = conn.in_seq
            if self._auth_provider is not None:
                # the authorizer is bound to the dialed address;
                # providers take the target (a failure yields an empty
                # blob, which a verifying acceptor rejects)
                target = f"{conn.peer_addr[0]}:{conn.peer_addr[1]}"
                try:
                    announce.auth_blob = (
                        self._auth_provider(target) or b"")
                except Exception:
                    announce.auth_blob = b""
            writer.write(self._frame_of(announce))
            # lossless-peer: resend everything the peer hasn't acked
            for _, frame in conn._unacked:
                writer.write(frame)

            async def _send_loop():
                while True:
                    frames, fin = await self._next_send_batch(conn)
                    if frames:
                        writer.write(b"".join(frames))
                        if self.perf is not None:
                            self.perf.hinc("frames_per_drain", len(frames))
                        await writer.drain()
                    if fin:
                        raise ConnectionResetError

            # a dead reader (peer EOF/reset) must also tear the session
            # down, or buffered writes mask the death and resend never
            # happens — run both and fold when either side fails
            # ack_writer also on the dialing side: replies the peer pushes
            # over this session get acked so its _unacked list drains
            reader_task = asyncio.create_task(
                self._read_frames(conn, reader, ack_writer=writer)
            )
            sender_task = asyncio.create_task(_send_loop())
            try:
                done, pending = await asyncio.wait(
                    {reader_task, sender_task},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                for t in pending:
                    t.cancel()
                for t in done:
                    exc = t.exception()
                    if exc is not None and not isinstance(
                        exc, (ConnectionError, OSError)
                    ):
                        raise exc
            finally:
                # retrieve BOTH tasks' outcomes even when this coroutine
                # is itself cancelled mid-wait (messenger shutdown):
                # an unretrieved _send_loop exception warns at GC
                reader_task.cancel()
                sender_task.cancel()
                await asyncio.gather(reader_task, sender_task,
                                     return_exceptions=True)
                try:
                    writer.close()
                except (OSError, RuntimeError):
                    pass  # dead transport / loop already closed
            if conn._closed or self._stopped:
                break
            if conn.policy.lossy:
                break  # lossy teardown below
            await asyncio.sleep(self._retry)
        if conn.policy.lossy and not conn._closed and not self._stopped:
            # lossy client: the session dies with the socket (or the
            # failed dial) — no reconnect, no replay; tell the upper
            # layer to retry at its own protocol level (Objecter role)
            conn._closed = True
            conn._unacked.clear()
            for d in self._dispatchers:
                d.ms_handle_reset(conn)
        conn._closed = True

    # -- incoming ---------------------------------------------------------
    async def _on_accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peername = writer.get_extra_info("peername")
        if peername is None:  # died between accept and here: fold
            writer.close()
            return
        peer = peername[:2]
        # sessions are bidirectional: replies from dispatchers go back
        # over this same socket (conn.send), so the accepted side pumps
        # a send queue too; if the socket drops, the dialing peer owns
        # reconnect and we just fold.  The session OBJECT outlives the
        # socket: it is resolved from the first message's
        # (src, nonce, sid) so a reconnect reattaches queued/unacked
        # replies instead of dropping them
        try:
            first = await self._read_one(reader)
            first_msg = Message.from_bytes(first)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ValueError):
            try:
                writer.close()
            except (OSError, RuntimeError):
                pass  # dead transport / loop already closed
            return
        if self._auth_verifier is not None:
            blob = getattr(first_msg, "auth_blob", b"")
            ok = False
            try:
                ok = bool(self._auth_verifier(blob))
            except Exception:
                ok = False
            if not ok:
                self._log(1, f"rejecting unauthenticated session from "
                             f"{first_msg.src} at {peer}")
                try:
                    writer.close()
                except (OSError, RuntimeError):
                    pass  # dead transport / loop already closed
                return
        conn = self._resolve_accepted(first_msg, peer)
        conn._writer = writer
        self._accepted.add(conn)
        # ONE pump per session (not per socket): a stale socket's pump
        # consuming frames meant for a newer socket would strand replies
        # until the next reconnect.  The pump writes to whatever writer
        # is current; frames that hit a dead/absent writer stay in
        # _unacked and the next attach replays them.
        if conn._pump_task is None or conn._pump_task.done():
            conn._pump_task = asyncio.create_task(self._pump_session(conn))
        try:
            # the first frame is usually the dialer's session announce;
            # its piggybacked ack trims _unacked before we replay
            await self._process_frame(conn, first, first_msg,
                                      ack_writer=writer)
            # replies the dialer never acked are replayed on reconnect
            # (dup-suppressed on its side if the loss was only the ack)
            for _, frame in conn._unacked:
                try:
                    writer.write(frame)
                except (ConnectionError, OSError):
                    pass
            await self._read_frames(conn, reader, ack_writer=writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            pass
        finally:
            # a newer socket may already own the session: only detach
            # and notify if we are still the current one
            if conn._writer is writer:
                conn._writer = None
                self._accepted.discard(conn)
                if conn.in_seq > 0 and not self._stopped:
                    for d in self._dispatchers:
                        d.ms_handle_reset(conn)
            try:
                writer.close()
            except (OSError, RuntimeError):
                pass  # dead transport / loop already closed

    async def _pump_session(self, conn: Connection) -> None:
        """Session-lifetime sender for the accepted side: drains the
        send queue onto the CURRENT socket; frames that miss (detached
        or dead writer) are not lost — they sit in _unacked and the
        next reconnect replays them.  Queued frames cork into one
        write+drain like the dialing side."""
        while True:
            frames, fin = await self._next_send_batch(conn)
            w = conn._writer
            if frames and w is not None:
                try:
                    w.write(b"".join(frames))
                    if self.perf is not None:
                        self.perf.hinc("frames_per_drain", len(frames))
                    await w.drain()
                except (ConnectionError, OSError):
                    pass
            if fin:
                return

    async def _next_send_batch(self, conn: Connection):
        """The cork: block for the first frame, then greedily collect
        everything else already queued so the caller issues ONE
        write+drain for the whole burst.  Returns (frames, fin); fin
        means the close sentinel was seen — flush `frames` first, then
        tear down (a sentinel arriving alone still terminates: it is
        never swallowed)."""
        frames: List[bytes] = []
        fin = False
        while True:
            try:
                nxt = conn._send_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if nxt is None:
                return frames, True
            frames.append(nxt)
        if not frames:
            first = await conn._send_q.get()
            if first is None:
                return frames, True
            frames.append(first)
            while True:
                try:
                    nxt = conn._send_q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if nxt is None:
                    fin = True
                    break
                frames.append(nxt)
        return frames, fin

    def _resolve_accepted(self, msg: Message, peer: Addr) -> Connection:
        """Find or create the persistent accepted-side session for the
        dialer identified by the message's (src, nonce, sid)."""
        policy = self.get_policy(
            getattr(msg.src, "kind", None) if msg.src is not None else None)
        if policy.lossy and policy.server:
            # stateless server for lossy clients: the session lives and
            # dies with this socket — never retained, never replayed
            return Connection(self, peer, policy=policy)
        key = None
        if msg.src is not None and msg.nonce and msg.sid:
            key = (str(msg.src), msg.nonce, msg.sid)
            conn = self._accepted_sessions.get(key)
            if conn is not None and not conn._closed:
                conn.peer_addr = peer  # dialer's ephemeral port moved
                if key in self._accepted_sessions:
                    del self._accepted_sessions[key]  # LRU move-to-end
                self._accepted_sessions[key] = conn
                return conn
        conn = Connection(self, peer)
        if key is not None:
            while len(self._accepted_sessions) >= self._max_accepted_sessions:
                old_key = next(iter(self._accepted_sessions))
                self._accepted_sessions.pop(old_key)._close()
            self._accepted_sessions[key] = conn
        return conn

    async def _read_one(self, reader: asyncio.StreamReader) -> bytes:
        hdr = await reader.readexactly(_FRAME.size)
        blen, want = _FRAME.unpack(hdr)
        body = await reader.readexactly(blen)
        if self.crc_data and want and crc32c(body) != want:
            raise ConnectionResetError("crc mismatch")
        return body

    async def _read_frames(
        self,
        conn: Connection,
        reader: asyncio.StreamReader,
        ack_writer: Optional[asyncio.StreamWriter] = None,
    ) -> None:
        try:
            while True:
                body = await self._read_one(reader)
                t_recv = time.monotonic()
                msg = Message.from_bytes(body)
                # receive stamp for op-stage attribution: the tracker's
                # first stage delta (lat_recv_us) then covers frame
                # decode + dispatch queueing, measured from the moment
                # the frame's last byte arrived
                msg._recv_stamp = t_recv
                await self._process_frame(conn, body, msg, ack_writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            pass

    async def _process_frame(
        self,
        conn: Connection,
        body: bytes,
        msg: Message,
        ack_writer: Optional[asyncio.StreamWriter] = None,
    ) -> None:
        conn._handle_ack(msg.ack_seq)
        if isinstance(msg, MAck):
            return
        # dup suppression must survive socket turnover: key the
        # cumulative dispatched-seq by (src, nonce), one logical
        # lossless session per peer incarnation.  The delivered-seq
        # state advances ONLY AFTER dispatch returns: a dispatch that
        # dies (e.g. a message landing in an OSD's kill window, work
        # queue already stopped) must leave the frame "undelivered" so
        # the peer's replay re-dispatches it — advancing first turned
        # such frames into permanently lost ops (the thrash hunt's
        # 30 s client timeouts with every PG active).
        session = None
        if msg.src is not None and msg.nonce:
            src = str(msg.src)
            nonce, sids = self._peer_in_seq.get(src, (0, {}))
            if nonce != msg.nonce:  # new incarnation supersedes
                nonce, sids = msg.nonce, {}
                self._peer_in_seq[src] = (nonce, sids)
            last = sids.get(msg.sid, 0)
            if msg.seq <= last:
                # already dispatched in this or a prior socket of
                # the session; re-ack so the replayer trims
                self._send_ack(conn, ack_writer, last)
                return
            session = (src, nonce, sids)
        elif msg.seq <= conn.in_seq:
            return  # duplicate within this socket
        await self._dispatch(conn, msg, len(body))
        if session is not None:
            src, nonce, sids = session
            if msg.sid in sids:
                del sids[msg.sid]  # re-insert: LRU move-to-end
            elif len(sids) >= self._max_sids_per_peer:
                sids.pop(next(iter(sids)))  # evict least-recent
            sids[msg.sid] = msg.seq
            self._peer_in_seq[src] = (nonce, sids)
        conn.in_seq = msg.seq
        self._ack_later(conn, ack_writer)

    def _ack_later(self, conn: Connection, ack_writer) -> None:
        """Coalesced dispatch ack: hold the ack for ms_ack_delay hoping
        an outgoing data frame piggybacks it (replies usually follow
        dispatch within the window); only a session with no reverse
        traffic pays a dedicated MAck — and one flush covers every
        frame dispatched in the window, instead of one ack frame per
        data frame."""
        if ack_writer is None or conn.in_seq <= conn._ack_sent:
            return
        if conn._ack_timer is not None:
            return  # a flush is already armed; it reads the latest seq
        conn._ack_timer = self._loop.call_later(
            self._ack_delay, self._flush_ack, conn, ack_writer)

    def _flush_ack(self, conn: Connection, ack_writer) -> None:
        conn._ack_timer = None
        if conn._closed:
            return
        if conn.in_seq <= conn._ack_sent:
            if self.perf is not None:
                self.perf.inc("acks_piggybacked")
            return  # an outgoing frame carried it meanwhile
        if self.perf is not None:
            self.perf.inc("acks_dedicated")
        conn._ack_sent = conn.in_seq
        # ride the connection's send queue: the ack corks into the
        # sender's next write instead of paying its own syscall (the
        # sender task drains to the same socket ack_writer points at)
        conn._send_q.put_nowait(self._ack_frame(conn.in_seq))

    def _frame_of(self, msg: Message) -> bytearray:
        """One-allocation frame assembly: the body encodes directly
        after a reserved header slot in the SAME buffer (to_bytes +
        header concat paid two full-payload copies per send), and the
        frame crc runs over a zero-copy view of it."""
        e = Encoder()
        e.raw(b"\0" * _FRAME.size)
        msg.encode_into(e)
        buf = e.buf
        body = memoryview(buf)[_FRAME.size:]
        _FRAME.pack_into(buf, 0, len(body),
                         crc32c(body) if self.crc_data else 0)
        return buf

    def _ack_frame(self, ack_seq: int) -> bytes:
        ack = MAck()
        ack.ack_seq = ack_seq
        ack.src = self.entity
        ack.nonce = self.nonce
        return self._frame_of(ack)

    def _send_ack(self, conn: Connection, ack_writer, ack_seq: int) -> None:
        if ack_writer is None or not ack_seq:
            return
        if ack_seq > conn._ack_sent:
            conn._ack_sent = ack_seq
        try:
            ack_writer.write(self._ack_frame(ack_seq))
        except (ConnectionError, OSError):
            pass

    async def _dispatch(self, conn: Connection, msg: Message,
                        size: int) -> None:
        """Byte-budgeted: when ms_dispatch_throttle_bytes of payload are
        in flight to dispatchers, stop reading this socket (TCP then
        backpressures the peer — the reference policy throttle)."""
        # fault injection: a decoded-but-undispatched frame is exactly
        # what a kill boundary loses — DROP models that loss without a
        # kill; the enabled() guard keeps the disarmed path free of
        # even the ctx packing (hot path: every message crosses here)
        if fp.enabled("msg.frame.deliver"):
            if fp.failpoint("msg.frame.deliver",
                            mtype=type(msg).__name__,
                            entity=str(self.entity)) is fp.DROP:
                return
        # edge backpressure: gate-subject messages take a per-
        # connection in-flight grant BEFORE dispatch; while this peer
        # is over its cap, only ITS reader awaits here (TCP then
        # backpressures the peer's socket).  The grant is released by
        # the daemon's reply path via msg._gate_release, or below on a
        # dispatch failure (the frame will be replayed and re-gated).
        release = None
        gate = self._gate
        if gate is not None:
            nbytes = None
            try:
                nbytes = gate[0](msg)
            except Exception:
                nbytes = None
            if nbytes is not None:
                await self._gate_acquire(conn, int(nbytes))
                release = self._gate_release_fn(conn, int(nbytes))
                msg._gate_release = release
        try:
            await self._dispatch_inner(conn, msg, size)
        except BaseException:
            if release is not None:
                release()
            raise

    async def _dispatch_inner(self, conn: Connection, msg: Message,
                              size: int) -> None:
        for d in self._dispatchers:
            if d.ms_can_fast_dispatch(msg):
                # fast dispatch (reference ms_fast_dispatch): run the
                # handler inline on the loop — small control messages
                # (write acks, pings) skip the thread-pool round trip
                # and the byte budget
                t0 = time.perf_counter()
                try:
                    if not d.ms_dispatch(conn, msg):
                        self._log(0, f"unhandled message {msg!r}")
                except Exception as e:
                    self._log(1, f"fast dispatch failed for {msg!r}: "
                                 f"{e!r}; closing session for replay")
                    raise ConnectionResetError("dispatch failed") from e
                finally:
                    self._note_stall(msg, time.perf_counter() - t0)
                return
        if self._budget_free is None:
            self._budget_free = asyncio.Event()
            self._budget_free.set()
        while self._dispatch_budget <= 0:
            self._budget_free.clear()
            await self._budget_free.wait()
        self._dispatch_budget -= size
        try:
            handled = await asyncio.to_thread(self._dispatch_sync, conn, msg)
            if not handled:
                self._log(0, f"unhandled message {msg!r}")
        except Exception as e:
            # a dispatcher that raises (daemon mid-shutdown: stopped
            # work queue) means the frame was NOT delivered — drop the
            # socket so the peer replays it to the next incarnation,
            # instead of letting the exception escape as an unhandled
            # asyncio task error with the frame in limbo
            self._log(1, f"dispatch failed for {msg!r}: {e!r}; "
                         "closing session for replay")
            raise ConnectionResetError("dispatch failed") from e
        finally:
            self._dispatch_budget += size
            if self._dispatch_budget > 0 and self._budget_free is not None:
                self._budget_free.set()

    def _note_stall(self, msg: Message, elapsed: float) -> None:
        """Loop-stall sanitizer: a fast-dispatched handler that held
        the event loop past the threshold is a contract violation —
        every connection this messenger serves stalled with it."""
        if not self._stall_s or elapsed < self._stall_s:
            return
        LOOP_STALLS.append((str(self.entity), type(msg).__name__, elapsed))
        self._log(0, f"LOOP STALL: fast dispatch of {type(msg).__name__} "
                     f"held the event loop {elapsed * 1e3:.1f}ms "
                     f"(threshold {self._stall_s * 1e3:.0f}ms)")
        if self.perf is not None:
            self.perf.inc("loop_stalls")

    def _dispatch_sync(self, conn: Connection, msg: Message) -> bool:
        for d in self._dispatchers:
            if d.ms_dispatch(conn, msg):
                return True
        return False
