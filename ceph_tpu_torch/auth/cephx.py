"""Cephx-role ticket authentication.

Reference: src/auth/cephx/CephxProtocol.h — a Kerberos-like scheme:
the mon (auth server) shares a secret with every entity (keyring) and
with the services (the rotating service key); a client proves identity
to the mon via challenge-response, receives a SESSION KEY sealed under
its own secret plus a TICKET (name + caps + the same session key)
sealed under the service secret, and then authenticates every daemon
session by presenting the ticket + an HMAC authorizer.  Daemons verify
with only the service secret — the mon is not on the data path.

Crypto is stdlib-only: seal() is encrypt-then-MAC with an
HMAC-SHA256 keystream (CTR-style) and an HMAC tag; proofs and
authorizers are plain HMACs.  (The reference uses AES; the protocol
shape — challenges, tickets, authorizers, expiry — is what's mirrored
here.)

Port of ``ceph_tpu/auth/cephx.py``, name for name: a blob sealed, a
ticket issued or an authorizer built by either package verifies in the
other (the nonces come from ``secrets``, so no two seals are equal).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import struct
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ceph_tpu_torch.auth.keyring import Keyring, generate_secret
from ceph_tpu_torch.core.encoding import Decoder, Encoder

TICKET_VALIDITY = 3600.0  # seconds (reference auth_service_ticket_ttl)


class AuthError(Exception):
    pass


# -- sealed boxes (encrypt-then-MAC over an HMAC keystream) ---------------

def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hmac.new(key, nonce + struct.pack("<Q", counter),
                        hashlib.sha256).digest()
        counter += 1
    return bytes(out[:n])


def seal(key: bytes, plaintext: bytes) -> bytes:
    nonce = secrets.token_bytes(16)
    ks = _keystream(key, nonce, len(plaintext))
    ct = bytes(a ^ b for a, b in zip(plaintext, ks))
    mac = hmac.new(key, b"seal" + nonce + ct, hashlib.sha256).digest()
    return nonce + mac + ct


def unseal(key: bytes, blob: bytes) -> bytes:
    if len(blob) < 48:
        raise AuthError("sealed blob too short")
    nonce, mac, ct = blob[:16], blob[16:48], blob[48:]
    want = hmac.new(key, b"seal" + nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(mac, want):
        raise AuthError("sealed blob MAC mismatch")
    ks = _keystream(key, nonce, len(ct))
    return bytes(a ^ b for a, b in zip(ct, ks))


# -- tickets ---------------------------------------------------------------

@dataclass
class Ticket:
    name: str
    caps: str
    session_key: bytes
    expires: float

    def encode(self) -> bytes:
        e = Encoder()
        e.start(1, 1)
        e.string(self.name).string(self.caps)
        e.blob(self.session_key).f64(self.expires)
        e.finish()
        return e.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Ticket":
        d = Decoder(data)
        d.start(1)
        t = cls(name=d.string(), caps=d.string(),
                session_key=d.blob(), expires=d.f64())
        d.end()
        return t


class CephxServer:
    """The mon-side auth service (reference CephxServiceHandler)."""

    def __init__(self, keyring: Keyring,
                 service_secret: Optional[bytes] = None) -> None:
        self.keyring = keyring
        self.service_secret = (service_secret
                               or keyring.get("service")
                               or generate_secret())
        self._challenges: Dict[str, Tuple[bytes, float]] = {}

    def get_challenge(self, name: str) -> bytes:
        ch = secrets.token_bytes(16)
        self._challenges[name] = (ch, time.time() + 60.0)
        return ch

    def handle_request(self, name: str, client_challenge: bytes,
                       proof: bytes, caps: str = "allow *",
                       now: Optional[float] = None) -> Tuple[bytes, bytes]:
        """Verify the proof, return (sealed_for_client, ticket_blob).

        proof = HMAC(entity_secret, server_challenge || client_challenge)
        sealed_for_client = seal(entity_secret, session_key || expires)
        ticket_blob = seal(service_secret, Ticket)
        """
        now = time.time() if now is None else now
        secret = self.keyring.get(name)
        if secret is None:
            raise AuthError(f"unknown entity {name!r}")
        got = self._challenges.pop(name, None)
        if got is None or got[1] < now:
            raise AuthError("no live challenge; restart the handshake")
        server_challenge = got[0]
        want = hmac.new(secret, server_challenge + client_challenge,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(proof, want):
            raise AuthError(f"bad proof for {name!r}")
        session_key = generate_secret()
        expires = now + TICKET_VALIDITY
        ticket = Ticket(name, caps, session_key, expires)
        e = Encoder()
        e.blob(session_key).f64(expires)
        sealed_client = seal(secret, e.bytes())
        ticket_blob = seal(self.service_secret, ticket.encode())
        return sealed_client, ticket_blob

    def mint_authorizer(self, name: str, caps: str = "allow *",
                        target: str = "") -> bytes:
        """Self-issued authorizer for the auth service itself — the mon
        holds the service secret, so its dial-backs (map pushes) carry
        a ticket daemons can verify like any other."""
        session_key = generate_secret()
        ticket = Ticket(name, caps, session_key,
                        time.time() + TICKET_VALIDITY)
        blob = seal(self.service_secret, ticket.encode())
        return build_authorizer_blob(blob, session_key, target)


class CephxClient:
    """Client half: proves identity, keeps the ticket, builds
    per-connection authorizers (reference CephxClientHandler)."""

    def __init__(self, name: str, secret: bytes) -> None:
        self.name = name
        self.secret = secret
        self.session_key: Optional[bytes] = None
        self.ticket_blob: Optional[bytes] = None
        self.expires = 0.0

    def make_proof(self, server_challenge: bytes,
                   client_challenge: bytes) -> bytes:
        return hmac.new(self.secret, server_challenge + client_challenge,
                        hashlib.sha256).digest()

    def accept_reply(self, sealed_client: bytes, ticket_blob: bytes) -> None:
        d = Decoder(unseal(self.secret, sealed_client))
        self.session_key = d.blob()
        self.expires = d.f64()
        self.ticket_blob = ticket_blob

    @property
    def authenticated(self) -> bool:
        return (self.session_key is not None
                and time.time() < self.expires)

    def build_authorizer(self, target: str = "") -> bytes:
        """ticket + HMAC(session_key, stamp || target) — presented per
        session; `target` (the dialed daemon's address) binds the blob
        to one destination."""
        if not self.authenticated:
            raise AuthError("no live ticket")
        return build_authorizer_blob(self.ticket_blob, self.session_key,
                                     target)


def _authorizer_mac(session_key: bytes, stamp: float,
                    target: str, nonce: bytes) -> bytes:
    # every variable-length field is LENGTH-PREFIXED inside the MAC:
    # without framing, bytes could be moved between target and nonce
    # (e.g. re-encode with target="" and nonce=old_target+old_nonce) to
    # strip the destination binding while keeping the MAC valid
    t = target.encode()
    return hmac.new(
        session_key,
        b"authorizer" + struct.pack("<d", stamp)
        + struct.pack("<I", len(t)) + t
        + struct.pack("<I", len(nonce)) + nonce,
        hashlib.sha256).digest()


def build_authorizer_blob(ticket_blob: bytes, session_key: bytes,
                          target: str = "") -> bytes:
    """The MAC covers (stamp, target, a fresh nonce): target binding
    stops cross-daemon replay, the nonce + the verifier's seen-cache
    stop same-daemon replay within the clock-skew window (the
    reference's CVE-2018-1128 challenge fix, collapsed into the
    one-shot announce shape)."""
    e = Encoder()
    e.start(2, 1)
    stamp = time.time()
    nonce = secrets.token_bytes(16)
    e.blob(ticket_blob).f64(stamp)
    e.blob(_authorizer_mac(session_key, stamp, target, nonce))
    e.string(target)
    e.blob(nonce)
    e.finish()
    return e.bytes()


def verify_authorizer(service_secret: bytes, blob: bytes,
                      now: Optional[float] = None,
                      max_skew: float = 300.0,
                      expect_target: str = "",
                      seen: Optional[Dict[bytes, float]] = None) -> Ticket:
    """Daemon-side check: unseal the ticket with the service secret,
    validate expiry, target binding, the session-key HMAC and — when a
    `seen` cache is provided — reject replays of a previously-used
    authorizer (reference cephx_verify_authorizer + the CVE-2018-1128
    challenge)."""
    now = time.time() if now is None else now
    d = Decoder(blob)
    v = d.start(2)
    ticket_blob = d.blob()
    stamp = d.f64()
    mac = d.blob()
    target = d.string() if v >= 2 else ""
    nonce = d.blob() if v >= 2 else b""
    d.end()
    ticket = Ticket.decode(unseal(service_secret, ticket_blob))
    if ticket.expires < now:
        raise AuthError(f"ticket for {ticket.name!r} expired")
    if abs(now - stamp) > max_skew:
        raise AuthError("authorizer stamp outside clock skew window")
    if expect_target and v >= 2 and target != expect_target:
        # an EMPTY target on a v2 blob is also a mismatch: accepting it
        # would let a stripped binding through
        raise AuthError(
            f"authorizer bound to {target!r}, not {expect_target!r}")
    want = _authorizer_mac(ticket.session_key, stamp, target, nonce)
    if not hmac.compare_digest(mac, want):
        raise AuthError(f"authorizer MAC mismatch for {ticket.name!r}")
    if seen is not None:
        for k in [k for k, exp in seen.items() if exp < now]:
            del seen[k]
        if mac in seen:
            raise AuthError("authorizer replayed")
        # the entry must outlive the blob's validity, which ends at
        # stamp + max_skew (a fast client clock extends it past
        # now + max_skew)
        seen[mac] = stamp + max_skew
    return ticket
