"""Admin socket — live JSON command endpoint per daemon.

Reference: AdminSocket (src/common/admin_socket.h:41) — a unix-domain
socket each daemon serves; `ceph daemon <name> <cmd>` sends a JSON
command and reads a JSON reply.  Built-ins registered here mirror the
reference set: perf dump, config get/set/diff, log dump, help.
Protocol: one JSON object per line in, one JSON document out,
connection closed after each command (matches the reference's
one-shot framing).

Port of ``ceph_tpu/core/admin_socket.py``, name for name.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Any, Callable, Dict


class AdminSocket:
    def __init__(self, path: str) -> None:
        self.path = path
        self._commands: Dict[str, tuple[Callable[[Dict[str, Any]], Any], str]] = {}
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.register("help", lambda cmd: {
            name: desc for name, (_, desc) in sorted(self._commands.items())
        }, "list available commands")

    def register(
        self,
        prefix: str,
        fn: Callable[[Dict[str, Any]], Any],
        desc: str = "",
    ) -> None:
        self._commands[prefix] = (fn, desc)

    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._sock.settimeout(0.25)
        self._thread = threading.Thread(
            target=self._serve, name="admin-socket", daemon=True
        )
        self._thread.start()

    def _serve(self) -> None:
        assert self._sock is not None
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                # transient accept error (e.g. EMFILE): back off instead
                # of spinning a core while the condition persists — on
                # the stop event, so shutdown interrupts the back-off
                self._stop.wait(0.25)
                continue
            try:
                data = b""
                conn.settimeout(5.0)
                try:
                    while b"\n" not in data:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        data += chunk
                    reply = self._handle(data.split(b"\n", 1)[0])
                except socket.timeout:
                    reply = b'{"error": "request timed out"}\n'
                conn.sendall(reply)
            except OSError:
                pass
            finally:
                conn.close()

    def _handle(self, line: bytes) -> bytes:
        try:
            cmd = json.loads(line.decode("utf-8") or "{}")
            prefix = cmd.get("prefix", "help")
            entry = self._commands.get(prefix)
            if entry is None:
                out: Any = {"error": f"unknown command {prefix!r}"}
            else:
                out = entry[0](cmd)
        except Exception as e:  # noqa: BLE001 — never kill the server
            out = {"error": str(e)}
        return json.dumps(out, default=str).encode("utf-8") + b"\n"

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass


def admin_command(path: str, prefix: str, **kwargs: Any) -> Any:
    """Client side: `ceph daemon` equivalent."""
    cmd = {"prefix": prefix, **kwargs}
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.settimeout(5.0)
        s.connect(path)
        s.sendall(json.dumps(cmd).encode("utf-8") + b"\n")
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        return json.loads(data.decode("utf-8"))
    finally:
        s.close()
