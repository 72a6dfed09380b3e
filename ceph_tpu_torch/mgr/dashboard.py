"""Dashboard mgr module: read-only cluster UI + JSON API over HTTP.

Reference role: the ceph-mgr dashboard module
(src/pybind/mgr/dashboard/ — a CherryPy app serving cluster state and
a REST API).  Re-derived dependency-free: a stdlib ThreadingHTTPServer
renders one self-contained HTML status page (health, mons, OSDs,
pools, PG states, perf highlights) plus JSON endpoints and the
prometheus exposition the PrometheusModule already produces.

Data sources: the mgr's own aggregation (`MgrDaemon.collect`) and a
`mon_command` callable for cluster maps — the same split the reference
has (mgr modules read daemon stats locally and cluster maps via the
MgrStandby/MonClient session).

Port of ``ceph_tpu/mgr/dashboard.py``: the same routes, page and JSON.
``stop()`` shuts the server down and joins its thread.

Endpoints:
  GET /              HTML status page (auto-refreshing)
  GET /metrics       prometheus text exposition
  GET /api/status    mon `status`
  GET /api/health    mon `health`
  GET /api/df        mon `osd df` (per-OSD utilization nodes)
  GET /api/osds      mon `osd dump` (osds + pools)
  GET /api/pgs       mon `pg dump` (summarized counts + rows)
  GET /api/perf      mgr.collect()
"""

from __future__ import annotations

import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from ceph_tpu_torch.mgr.manager import MgrModule

MonCommand = Callable[[dict], Tuple[int, dict]]


class DashboardModule(MgrModule):
    name = "dashboard"

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self.server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port = 0
        self.mon_command: Optional[MonCommand] = None

    # -- lifecycle ---------------------------------------------------------
    def serve(self, port: int = 0,
              mon_command: Optional[MonCommand] = None) -> int:
        """Start the HTTP server (port 0 = ephemeral); returns the
        bound port."""
        self.mon_command = mon_command
        module = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    module._route(self)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    try:
                        self.send_response(500)
                        body = json.dumps({"error": repr(e)}).encode()
                        self.send_header("Content-Type",
                                         "application/json")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except Exception:
                        pass

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="mgr-dashboard", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def handle_command(self, cmd):
        if cmd.get("prefix") != "dashboard status":
            return None
        return 0, {"running": self.server is not None,
                   "url": f"http://127.0.0.1:{self.port}/"
                   if self.server else None}

    # -- data --------------------------------------------------------------
    def _mon(self, prefix: str, **kw) -> dict:
        if self.mon_command is None:
            return {"error": "dashboard has no mon session"}
        rc, out = self.mon_command({"prefix": prefix, **kw})
        if rc != 0:
            return {"error": out.get("error", f"rc={rc}"), "rc": rc}
        return out

    def _pg_summary(self) -> dict:
        dump = self._mon("pg dump")
        rows = dump.get("pg_stats", [])
        by_state: dict = {}
        for r in rows:
            st = r.get("state", "unknown")
            by_state[st] = by_state.get(st, 0) + 1
        return {"num_pgs": len(rows), "by_state": by_state,
                "pg_stats": rows}

    # -- routing -----------------------------------------------------------
    def _route(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?")[0].rstrip("/") or "/"
        if path == "/":
            self._send(h, self._render_html(), "text/html")
        elif path == "/metrics":
            self._send(h, self.mgr.modules["prometheus"].export(),
                       "text/plain; version=0.0.4")
        elif path == "/api/status":
            self._send_json(h, self._mon("status"))
        elif path == "/api/health":
            self._send_json(h, self._mon("health"))
        elif path == "/api/df":
            self._send_json(h, self._mon("osd df"))
        elif path == "/api/osds":
            self._send_json(h, self._mon("osd dump"))
        elif path == "/api/pgs":
            self._send_json(h, self._pg_summary())
        elif path == "/api/perf":
            self._send_json(h, self.mgr.collect())
        else:
            self._send(h, "not found", "text/plain", code=404)

    @staticmethod
    def _send(h, body: str, ctype: str, code: int = 200) -> None:
        data = body.encode()
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _send_json(self, h, obj) -> None:
        self._send(h, json.dumps(obj, default=str, indent=1),
                   "application/json")

    # -- page --------------------------------------------------------------
    def _render_html(self) -> str:
        status = self._mon("status")
        health = self._mon("health")
        osd_df = self._mon("osd df")
        osds = self._mon("osd dump")
        pgs = self._pg_summary()

        def esc(v) -> str:
            return html.escape(str(v))

        checks = health.get("checks", {}) or {}
        hstatus = health.get("status", status.get("health", "?"))
        hcolor = {"HEALTH_OK": "#2a2", "HEALTH_WARN": "#c80",
                  "HEALTH_ERR": "#c22"}.get(str(hstatus), "#888")
        util = {n.get("osd"): n for n in osd_df.get("nodes", [])}
        rows = []
        for o in osds.get("osds", []):
            n = o.get("osd")
            u = util.get(n, {})
            state = ("up" if o.get("up") else "down") + \
                "/" + ("in" if o.get("in") else "out")
            rows.append(
                f"<tr><td>osd.{esc(n)}</td><td>{esc(state)}</td>"
                f"<td>{esc(o.get('weight', ''))}</td>"
                f"<td>{esc(u.get('used_bytes', ''))}</td>"
                f"<td>{esc(round(float(u.get('utilization', 0)), 4))}"
                f"</td></tr>")
        pools = []
        for p in osds.get("pools", []):
            pools.append(
                f"<tr><td>{esc(p.get('name'))}</td>"
                f"<td>{esc(p.get('pool', ''))}</td>"
                f"<td>{esc('ec' if p.get('type') == 3 else 'rep')}</td>"
                f"<td>{esc(p.get('size', ''))}</td>"
                f"<td>{esc(p.get('pg_num', ''))}</td></tr>")
        states = "".join(
            f"<tr><td>{esc(s)}</td><td>{c}</td></tr>"
            for s, c in sorted(pgs["by_state"].items()))
        checks_html = "".join(
            f"<li><b>{esc(k)}</b>: {esc(v.get('summary', v))}</li>"
            for k, v in checks.items()) or "<li>none</li>"
        return f"""<!doctype html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="5">
<title>ceph_tpu dashboard</title>
<style>
 body {{ font: 14px/1.4 system-ui, sans-serif; margin: 2em;
         color: #222; }}
 h1 {{ font-size: 1.3em; }} h2 {{ font-size: 1.05em; margin-top: 1.4em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: 2px 10px; text-align: left; }}
 .pill {{ color: #fff; padding: 2px 10px; border-radius: 9px;
          background: {hcolor}; }}
 code {{ background: #f4f4f4; padding: 1px 4px; }}
</style></head><body>
<h1>ceph_tpu cluster <span class="pill">{esc(hstatus)}</span></h1>
<p>epoch {esc(status.get('osdmap_epoch', status.get('epoch', '?')))} ·
quorum leader: mon.{esc(status.get('quorum_leader', '?'))}
(election e{esc(status.get('election_epoch', '?'))}) ·
osds: {esc(status.get('num_osds', '?'))}
({esc(status.get('num_up_osds', '?'))} up) ·
pgs: {pgs['num_pgs']}</p>
<h2>Health checks</h2><ul>{checks_html}</ul>
<h2>PG states</h2>
<table><tr><th>state</th><th>count</th></tr>{states}</table>
<h2>OSDs</h2>
<table><tr><th>osd</th><th>state</th><th>weight</th><th>used</th>
<th>util</th></tr>
{''.join(rows)}</table>
<h2>Pools</h2>
<table><tr><th>pool</th><th>id</th><th>type</th><th>size</th>
<th>pg_num</th></tr>
{''.join(pools)}</table>
<p>API: <code>/api/status</code> <code>/api/health</code>
<code>/api/df</code> <code>/api/osds</code> <code>/api/pgs</code>
<code>/api/perf</code> · metrics: <code>/metrics</code></p>
</body></html>"""
