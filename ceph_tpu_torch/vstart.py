"""VStartCluster — the dev/test cluster launcher (vstart.sh role).

Port of ``ceph_tpu/vstart.py``.  ``VStartCluster(..., device=None)``
hands its device to every ``Monitor``, ``OSDService`` and
``RadosClient`` it makes and to the seed ``OSDMap``: None means the
card, and raises before any socket or thread exists when there is none;
``device="cpu"`` runs each kernel's plain version.  The reference's
``tpu_compile_cache_dir`` default (a persistent XLA cache under
``data_dir``) has no counterpart and is not set: the port compiles no
XLA program, and its CUDA kernels are built once a checkout into
``ceph_tpu_torch/_build/``.  ``start_mgr`` starts the port's mgr
(``ceph_tpu_torch/mgr/``); the MDS and cephfs (``start_mds``,
``fs_status``, ``mount``) are ROADMAP queue 1 item 6d of the port and
raise ``NotImplementedError``.

Reference: src/vstart.sh + src/mstart.sh — bring up N mons + M osds on
localhost with real sockets, wait for quorum and OSD boot, create
pools, hand out connected clients.  Here the daemons are in-process
objects over real TCP messengers (the same daemons the tier-3 tests
exercise), so one Python process IS a whole cluster:

    from ceph_tpu_torch.vstart import VStartCluster
    with VStartCluster(n_mons=3, n_osds=4) as c:
        pool = c.create_pool("data", size=3)
        io = c.client().ioctx(pool)
        io.write_full("obj", b"hello")
        assert io.read("obj") == b"hello"

Stores default to MemStore; pass data_dir= for durable per-OSD
filestores or blockstores (``store_kind``) and LSMStore mon stores
(survives shutdown; a new VStartCluster over the same dir remounts
them).  keyring=True enables cephx end to end (mon mints, every
daemon and client authenticates).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Optional

from ceph_tpu_torch.client import RadosClient
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.mon.monitor import MonMap, Monitor
from ceph_tpu_torch.osd.daemon import OSDService
from ceph_tpu_torch.osd.osdmap import OSDMap


def _free_ports(n: int) -> List[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class VStartCluster:
    def __init__(self, n_mons: int = 1, n_osds: int = 3,
                 data_dir: Optional[str] = None,
                 store_kind: str = "filestore",
                 keyring: bool = False,
                 conf: Optional[dict] = None,
                 warmup: bool = False,
                 wait: bool = True,
                 device=None) -> None:
        # resolved first: without a card, device=None raises here,
        # before a socket or a thread exists
        self.device = resolve_device(device)
        self.n_mons = n_mons
        self.n_osds = n_osds
        # wakes wait_for() pollers the moment the cluster shuts
        # down (no 0.2 s residual sleep, no wait against a corpse)
        self._stop_evt = threading.Event()
        self.data_dir = data_dir
        self.store_kind = store_kind  # for data_dir: filestore|blockstore
        self.mgr = None             # start_mgr's MgrDaemon
        self._crash_archive = None  # its crash spool, with a data_dir
        merged = {
            "osd_heartbeat_interval": 0.5,
            "osd_heartbeat_grace": 3.0,
            "mon_tick_interval": 0.5,
            **(conf or {}),
        }
        if warmup:
            merged.setdefault("tpu_boot_warmup", True)
        self.ctx = Context("vstart", merged)
        self.keyring = None
        if keyring:
            from ceph_tpu_torch.auth.keyring import Keyring

            self.keyring = Keyring()
            self.keyring.add("service")  # rotating service key
            for i in range(n_osds):
                self.keyring.add(f"osd.{i}")
            self.keyring.add("client.admin")

        cm_, root = cmap.build_flat_cluster(n_osds, hosts=n_osds)
        seed = OSDMap(cm_, max_osd=n_osds, device=self.device)
        seed.osd_state_up[:] = False  # everyone boots through the mon

        ports = _free_ports(n_mons)
        self.monmap = MonMap([("127.0.0.1", p) for p in ports])
        self.mons: List[Monitor] = []
        for rank in range(n_mons):
            kv = None
            if data_dir is not None:
                # durable MonitorDBStore (the RocksDB role): paxos
                # state + service DBs spill to disk via the LSM store
                from ceph_tpu_torch.store.lsm import LSMStore

                kv = LSMStore(os.path.join(data_dir, f"mon{rank}"))
            mon = Monitor(self.ctx, rank, self.monmap, initial_map=seed,
                          bind_port=ports[rank], keyring=self.keyring,
                          kv=kv, device=self.device)
            mon.start()
            self.mons.append(mon)

        self.osds: Dict[int, OSDService] = {}
        self._clients: List[RadosClient] = []
        for i in range(n_osds):
            self.osds[i] = self._spawn_osd(i)
        if wait:
            self.wait_for_up()

    # -- mgr (reference vstart.sh always starts one) ----------------------
    def start_mgr(self, dashboard: bool = False,
                  dashboard_port: int = 0):
        """Start the in-process mgr: every daemon's perf counters are
        registered, and `dashboard=True` serves the HTTP status UI /
        JSON API / prometheus endpoint (returns the MgrDaemon; its
        dashboard port is in mgr.modules['dashboard'].port).  A second
        call replaces the running mgr: its dashboard is stopped and its
        crash spool's hooks uninstalled first."""
        from ceph_tpu_torch.mgr.manager import MgrDaemon

        if self.mgr is not None:
            self.mgr.modules["dashboard"].stop()
            self.mgr = None
        if self._crash_archive is not None:
            self._crash_archive.uninstall()
            self._crash_archive = None
        mgr = MgrDaemon(self.ctx)
        # vstart daemons often share one Context (one perf collection):
        # register each DISTINCT context once so counters aren't
        # duplicated under every daemon label
        pairs = [(f"mon.{r}", self.ctx) for r in range(len(self.mons))]
        pairs += [(f"osd.{i}", svc.ctx) for i, svc in self.osds.items()]
        seen: Dict[int, str] = {}
        for name, dctx in pairs:
            if id(dctx) in seen:
                continue
            label = "cluster" if dctx is self.ctx else name
            seen[id(dctx)] = label
            mgr.register_daemon(label, dctx)
        # op trackers are per-SERVICE even when contexts are shared:
        # every OSD joins the ops-module slow-op/in-flight merge
        for i, svc in self.osds.items():
            mgr.register_service(f"osd.{i}", svc)
        # durable clusters get a crash spool the CrashModule serves
        # (`ceph crash ls` / `crash info`): unhandled daemon-thread /
        # main-thread / event-loop deaths archive here with the
        # device section (queue depth, in-flight batch, the kernel
        # build and launches)
        if self.data_dir is not None:
            from ceph_tpu_torch.core.crash import CrashArchive

            arch = CrashArchive(os.path.join(self.data_dir, "crash"),
                                entity="cluster", log=self.ctx.log)
            arch.install()
            mgr.modules["crash"].add_archive(arch)
            self._crash_archive = arch
        mgr.osdmap = self.leader().osdmap
        # cluster telemetry feeds resolve the CURRENT leader per call:
        # an election mid-session must not leave the mgr reading a
        # deposed mon's frozen pgmap
        mgr.health_fn = \
            lambda: self.leader().services["health"].gather()
        mgr.pgmap_digest_fn = lambda: self.leader().pgmap.digest()
        # fresh_only: the progress module must see the same
        # staleness-filtered view health uses, or a dead reporter's
        # frozen degraded row keeps a recovery event (and its ETA)
        # alive forever after health has already cleared
        mgr.pg_rows_fn = \
            lambda: self.leader().pgmap.pg_rows(fresh_only=True)
        if dashboard:
            mgr.modules["dashboard"].serve(
                port=dashboard_port, mon_command=self.command)
        self.mgr = mgr
        return mgr

    # -- MDS and cephfs: ROADMAP queue 1 item 6d ---------------------------
    def start_mds(self, pool_name: str = "cephfs_meta", ranks: int = 1,
                  size: int = 2):
        """The reference's MDS ranks; the port's cephfs is ROADMAP queue
        1 item 6d."""
        raise NotImplementedError(
            "VStartCluster.start_mds: the port's MDS and cephfs are ROADMAP "
            "queue 1 item 6d")

    def fs_status(self) -> dict:
        raise NotImplementedError(
            "VStartCluster.fs_status: the port's MDS and cephfs are ROADMAP "
            "queue 1 item 6d")

    def mount(self, name: str = "admin"):
        raise NotImplementedError(
            "VStartCluster.mount: the port's cephfs client is ROADMAP queue "
            "1 item 6d")

    # -- daemons -----------------------------------------------------------
    def _make_store(self, i: int):
        if self.data_dir is None:
            from ceph_tpu_torch.store.memstore import MemStore

            return MemStore(), True
        from ceph_tpu_torch.store import create

        path = os.path.join(self.data_dir, f"osd{i}")
        marker = "wal.log" if self.store_kind == "filestore" else "block"
        fresh = not os.path.exists(os.path.join(path, marker))
        os.makedirs(path, exist_ok=True)
        kw = {}
        # objectstore_wal_sync turns on per-batch durability (fsync in
        # the group-commit thread): FileStore's WAL fsync / BlockStore's
        # o_sync discipline
        if self.ctx.conf.get("objectstore_wal_sync"):
            kw["wal_sync" if self.store_kind == "filestore"
               else "o_sync"] = True
        return create(self.store_kind, path=path, **kw), fresh

    def _spawn_osd(self, i: int) -> OSDService:
        store, fresh = self._make_store(i)
        svc = OSDService(self.ctx, i, store, None, codec_from_profile,
                         device=self.device)
        if fresh:
            svc.store.mkfs()
        svc.init()
        svc.boot(self.monmap, keyring=self.keyring)
        svc.start_heartbeats()
        return svc

    # -- orchestration -----------------------------------------------------
    def leader(self) -> Monitor:
        """The live mon that leads.  A mon shut down keeps its last
        state, so it is skipped: the mgr's feeds and ``osd tree`` follow
        the leader the others elect after it."""
        for mon in self.mons:
            if mon.state == "leader" and not mon.stopped:
                return mon
        raise RuntimeError("no mon leader")

    def wait_for(self, pred, timeout: float = 30.0,
                 what: str = "condition") -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                if pred():
                    return
            # cephlint: disable=silent-except — predicates probe
            # half-booted daemons; failure IS the wait state
            except Exception:
                pass
            if self._stop_evt.wait(0.2):
                raise RuntimeError(
                    f"vstart: shut down while waiting for {what}")
        raise TimeoutError(f"vstart: timeout waiting for {what}")

    def wait_for_up(self, timeout: float = 30.0) -> None:
        self.wait_for(lambda: any(m.state == "leader" for m in self.mons),
                      timeout, "mon quorum")

        def all_up() -> bool:
            m = self.leader().osdmap
            return m is not None and int(m.osd_state_up.sum()) == len(
                [o for o in self.osds.values() if o.up])

        self.wait_for(all_up, timeout, "osd boot")

    def command(self, cmd: dict) -> tuple:
        """Admin command against the current leader (ceph CLI role)."""
        client = self.client()
        return client.mon_command(cmd)

    def create_pool(self, name: str, size: int = 3,
                    pool_type: str = "replicated",
                    ec_profile: str = "", pg_num: int = 8) -> int:
        cmd = {"prefix": "osd pool create", "pool": name,
               "pg_num": pg_num, "pool_type": pool_type, "size": size}
        if ec_profile:
            self.command({"prefix": "osd erasure-code-profile set",
                          "name": name + "_profile",
                          "profile": ec_profile})
            cmd["erasure_code_profile"] = name + "_profile"
        code, out = self.command(cmd)
        if code != 0:
            raise RuntimeError(f"pool create failed: {out}")
        pool_id = out.get("pool_id")

        def visible() -> bool:
            m = self.leader().osdmap
            return m is not None and pool_id in m.pools

        self.wait_for(visible, what=f"pool {name}")
        if bool(self.ctx.conf.get("tpu_boot_warmup")):
            # boot warmup ran codec-less (no pools existed yet); now
            # that one does, resume the pending codec/CRUSH items so
            # first ops against this pool hit warm kernels
            def osdmaps_caught_up() -> bool:
                e = self.leader().osdmap.epoch
                return all(o.epoch() >= e for o in self.osds.values()
                           if o.up)

            self.wait_for(osdmaps_caught_up,
                          what=f"osd maps for pool {name}")
            for o in self.osds.values():
                if o.up:
                    o.device_warmup()
        return pool_id

    def client(self) -> RadosClient:
        auth = None
        if self.keyring is not None:
            auth = ("client.admin", self.keyring.get("client.admin"))
        rc = RadosClient(Context("client.vstart", {}), device=self.device)
        rc.connect(self.monmap, auth=auth)
        self._clients.append(rc)
        return rc

    def kill_osd(self, i: int) -> None:
        self.osds[i].shutdown()

    def revive_osd(self, i: int) -> None:
        old = self.osds[i]
        svc = OSDService(self.ctx, i, old.store, None, codec_from_profile,
                         device=self.device)
        svc.init()
        svc.boot(self.monmap, keyring=self.keyring)
        svc.start_heartbeats()
        self.osds[i] = svc
        # the revived daemon owns a FRESH op tracker: repoint the mgr
        # ops-module merge at it, or the cluster-wide slow-op/in-flight
        # surface keeps serving the dead service's frozen rings
        if self.mgr is not None:
            self.mgr.register_service(f"osd.{i}", svc)

    def shutdown(self) -> None:
        self._stop_evt.set()
        if self._crash_archive is not None:
            # global hooks must not outlive the cluster
            self._crash_archive.uninstall()
        if self.mgr is not None:
            self.mgr.modules["dashboard"].stop()
        for rc in self._clients:
            try:
                rc.shutdown()
            except Exception:
                pass
        self._clients.clear()
        for o in self.osds.values():
            if o.up:
                o.shutdown()
        for mon in self.mons:
            mon.shutdown()

    def __enter__(self) -> "VStartCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
