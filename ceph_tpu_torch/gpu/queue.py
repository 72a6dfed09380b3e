"""StripeBatchQueue — coalesce concurrent EC encodes and decodes into
one device batch.

Port of ``ceph_tpu/tpu/queue.py``.  For the flat codecs (RS and the
GF(2) bit-matrix techniques), kinds ``enc`` (coding planes), ``encp``
(coding planes + per-shard CRC-32C) and ``dec`` (data planes rebuilt
from k survivors, for codecs whose recovery is one MDS matrix product:
the RS codecs; a bit-matrix code or shec decodes through
``codec.decode``).
Submit refuses what a batch cannot run, with a ``TypeError``: ``dec``
for a codec without ``mds_recovery`` (the JAX queue takes shec there and
fails in its worker), ``enc``/``encp`` for a codec without
``encode_planes`` (lrc, which encodes through ``encode_array``; the JAX
queue has no lrc route either).  Callers hand a
job's host planes to the queue and wait on a future; a worker thread
greedily drains jobs that share (codec, kind, survivor signature, row
count), the same coalescing key as queue.py:287-290, and runs them as
one batch.

A batch on the device:

1. the jobs' planes are copied job after job into one pinned upload
   buffer (the queue's own, ``_upload_pool``) and cross host -> device
   in ONE copy;
2. on the device they are laid side by side into a [rows, P] batch,
   P the covering bucket of the total width (queue.py:469), the pad
   zero-filled; for ``encp`` the batch has m more rows below, and the
   coding planes are written straight into them;
3. one product runs over the batch: the codec's ``encode_planes`` with
   the jobs' extents (an RS code is column-local and codes the whole
   batch; a bit-matrix code splits each job's chunk rows into its own w
   packets, so every job gets exactly what ``encode_array`` gives it
   alone), or the signature's recovery matrix with the batch donated;
   then for ``encp`` one CRC launch over every (job, shard) row of the
   [k+m, P] batch, read in place at each job's column offset;
4. results come back as host numpy: coding [m, n] plus CRCs u32 [k+m]
   for ``encp``, coding [m, n] for ``enc``, data planes [k, n] for
   ``dec`` — the contract of queue.py:323,330,502.

The worker sets its CUDA device and orders the upload, the kernels and
the downloads on one stream of its own.  Each batch passes the
``queue.batch.dispatch`` failpoint before it is dispatched (an error
armed there reaches every future of that batch, and the worker serves
on), and each completed batch is noted in the device watch
(``gpu/devwatch.py``).  While a batch is on the worker,
``inflight_batch()`` describes it (queue.py:130), for the crash
report's device section.

Each entry point takes ``trop=``, the client op riding the job.  The
reference blames a live XLA compile on an op (queue.py:530-563); the
port's compiles are the kernel build (``ops/_build.py``) and each
kernel's first launch at a new signature (``gpu/devwatch.py``), so a
job whose [enqueue, compute-done] window overlapped one gets the
``compile_wait`` annotation and the ``lat_compile_wait_us`` sample of
its tracker.  With none in the window this costs one comparison per
batch.

An array codec (clay: ``codec.is_array``, sub-chunks) takes the clay
kinds: ``crep`` (``clay_repair_async``: a single lost shard from its
d helpers' repair layers, [d*L, s] rows of sub-chunks) and ``cdec``
(``clay_decode_async``: the k data chunks from every survivor, [A*Z, s]
rows), and ``enc``/``encp`` as the flat codecs.  Their jobs lie side by
side along the INTRA-sub-chunk byte axis s, not the raw columns
(queue.py:332-343): the coupled-layer steps are elementwise over s, and
a raw concatenation would let the layer axis take a neighbour's bytes.
The batch's s is covering-padded (``shapebucket.covering``), laid out
on the device as [rows, Z or 1, s_pad], and the codec runs once over it
(``encode_planes``, ``repair_planes``, ``decode_planes``).  For
``encp`` each job's chunk rows are then gathered on the device into one
[k+m, sum of widths] batch in their own layout, and one CRC launch
reads them there (the reference rebuilds that layout on the host,
queue.py:392-409).

With ``mesh=`` (a ``gpu/meshio.MeshCompute``), a flat batch of a
codec with ``mds_recovery`` (the RS codecs) rides the mesh
(queue.py:301-330): ``enc`` and ``encp`` through ``encode_scatter``
with the codec's coding matrix, written into the batch's coding rows,
``dec`` through ``recovery_gather``, both kept on the device; each such
batch counts in ``mesh_batches``.  ``encp``'s CRC then runs over the
batch on the queue's device as without a mesh.  An array codec keeps
its own batch, and so does every codec without ``mds_recovery`` (the
bit-matrix codes, shec): the route follows that one capability, as the
``dec`` kind does.

``default_queue(device)`` is the process's queue for one resolved
device (queue.py:581): the CPU's and the card's never mix, and every
one is stopped at interpreter exit.
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.perf import PerfCounters, SnapshotRing
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.gpu import devwatch, shapebucket
from ceph_tpu_torch.gpu.staging import DevPathStats, StagingPool
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.ops.crc32c_device import crc32c_rows

# the batch upload buffer: one slot holds a full coalesced batch of the
# 1 MiB-stripe config (k=8 x 1 Mi columns); a larger batch gets a pinned
# buffer of its own
UPLOAD_SLOT_BYTES = 16 << 20
UPLOAD_SLOTS = 2


class _Job:
    __slots__ = ("codec", "planes", "rows", "width", "kind", "sig", "size",
                 "t_enq", "trop", "future")

    def __init__(self, codec, planes: Sequence[np.ndarray], kind: str,
                 sig: Tuple[int, ...] = (), size: int = 0,
                 trop=None) -> None:
        self.codec = codec
        self.planes = planes        # rows x width host uint8 (2-D or list)
        self.rows = len(planes)
        self.width = int(len(planes[0])) if self.rows else 0
        self.kind = kind            # "enc" | "encp" | "dec" | "crep" | "cdec"
        self.sig = sig              # dec/cdec: survivor ids;
        #                             crep: (lost, *helpers)
        self.size = size or self.rows * self.width  # real payload bytes
        self.t_enq = time.monotonic()
        self.trop = trop            # the client op (TrackedOp), for blame
        self.future: Future = Future()


def _host_rows(rows, width: int) -> List[np.ndarray]:
    out = [np.ascontiguousarray(r, dtype=np.uint8).reshape(-1) for r in rows]
    if any(r.size != width for r in out):
        raise ValueError("every plane of a job needs the same width")
    return out


class StripeBatchQueue:
    def __init__(self, device=None, max_batch_cols: int = 1 << 20,
                 window_s: float = 0.0005, mesh=None) -> None:
        self.device = resolve_device(device)
        self.max_batch_cols = max_batch_cols
        self.window_s = window_s
        # optional MeshCompute (gpu/meshio.py): the RS codecs' flat
        # batches run over its grid instead of one K1 launch
        self.mesh = mesh
        self.mesh_batches = 0
        self._q: "queue.Queue[_Job | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.batches = 0       # device dispatches
        self.jobs = 0          # logical encodes/decodes
        self.bytes_in = 0      # plane bytes that rode the queue
        # jobs-per-batch histograms {width: batches}: the evidence that
        # concurrent submits coalesced (decode-only slice separately)
        self.batch_jobs: Dict[int, int] = {}
        self.dec_batch_jobs: Dict[int, int] = {}
        # the payload staging pool (the reference's queue.pool: payloads
        # land here through DeviceBuf.stage and hold their slot until
        # sealed) and, apart from it, the worker's own upload buffer, so
        # staged payloads waiting on a batch never starve the batch
        pin = self.device.type == "cuda"
        self.stats = DevPathStats()
        self.pool = StagingPool(pin=pin, stats=self.stats)
        self._upload_pool = StagingPool(slot_bytes=UPLOAD_SLOT_BYTES,
                                        slots=UPLOAD_SLOTS, pin=pin)
        self.perf = PerfCounters("gpu.queue")
        self.perf.add_histogram(
            "lat_encq_wait_us", "job enqueue -> batch start (us)")
        self.perf.add_histogram(
            "lat_device_us", "upload + device compute + download per "
            "coalesced batch (us)")
        self.perf.add_histogram(
            "lat_encq_dispatch_us", "batch result fan-out to futures (us)")
        self.perf.add_u64_gauge(
            "queue_depth", "jobs waiting in the stripe batch queue")
        self.perf.add_u64_gauge(
            "device_busy_pct",
            "device batch wall-fraction over the sample window (%)")
        self.perf.add_u64_gauge(
            "staging_slots_used", "pinned staging pool slots in use")
        self.device_time_s = 0.0
        self._gauge_ring = SnapshotRing(capacity=32)
        # the batch on the worker right now (kind, jobs, shapes, start
        # stamp), None while it coalesces or idles
        self._inflight_info: "Dict | None" = None

    def inflight_batch(self) -> "Dict | None":
        """The batch the worker is running now, with its age in
        seconds; None when idle."""
        info = self._inflight_info
        if info is None:
            return None
        out = dict(info)
        out["age_s"] = round(time.monotonic() - out.pop("t0"), 3)
        return out

    def sample(self, window_s: float = 10.0) -> None:
        """Refresh the queue-depth, busy and staging gauges."""
        self._gauge_ring.push({"device_s": self.device_time_s})
        busy = self._gauge_ring.rate("device_s", window_s)
        self.perf.set("device_busy_pct", int(round(min(1.0, busy) * 100)))
        self.perf.set("queue_depth", self._q.qsize())
        self.perf.set("staging_slots_used", self.pool.occupancy)

    def start(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="stripe-batch", daemon=True)
                self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            th, self._thread = self._thread, None
        if th is not None and th.is_alive():
            self._q.put(None)
            th.join(timeout=timeout)

    # -- API --------------------------------------------------------------
    def _submit(self, job: _Job) -> Future:
        self.start()
        self._q.put(job)
        return job.future

    @staticmethod
    def _check_encodes(codec) -> None:
        if not hasattr(codec, "encode_planes"):
            raise TypeError(f"{type(codec).__name__} has no encode_planes; "
                            "encode it through codec.encode_array")

    def encode_async(self, codec, planes: np.ndarray,
                     trop=None) -> Future:
        """planes uint8 [k, n] -> Future of coding planes [m, n]."""
        self._check_encodes(codec)
        planes = np.ascontiguousarray(planes, dtype=np.uint8)
        return self._submit(_Job(codec, planes, "enc", trop=trop))

    def encode(self, codec, planes: np.ndarray) -> np.ndarray:
        return self.encode_async(codec, planes).result()

    def encode_crc_async(self, codec, planes: np.ndarray,
                         size: int = 0, trop=None) -> Future:
        """Fused encode + per-shard crc32c: planes uint8 [k, n] ->
        Future of (coding [m, n], crcs u32 [k+m]).  Only the coding
        planes and the 4-byte digests come back to the host."""
        self._check_encodes(codec)
        planes = np.ascontiguousarray(planes, dtype=np.uint8)
        return self._submit(_Job(codec, planes, "encp", size=size,
                                 trop=trop))

    def decode_data_async(self, codec, available: Dict[int, np.ndarray],
                          trop=None) -> Future:
        """Survivor planes {shard: [n]} -> Future of data planes [k, n].
        Jobs sharing a survivor signature coalesce into one recovery
        product."""
        if not getattr(codec, "mds_recovery", False):
            raise TypeError(f"{type(codec).__name__} has no MDS recovery "
                            "matrix; decode it through codec.decode")
        sig = tuple(sorted(available))[: codec.k]
        if len(sig) < codec.k:
            raise ValueError(f"need {codec.k} survivors, have {len(sig)}")
        width = len(available[sig[0]])
        rows = _host_rows([available[i] for i in sig], width)
        return self._submit(_Job(codec, rows, "dec", sig=sig, trop=trop))

    def decode_data(self, codec, available) -> np.ndarray:
        return self.decode_data_async(codec, available).result()

    @staticmethod
    def _check_array(codec) -> int:
        if not codec.is_array:
            raise TypeError(f"{type(codec).__name__} is not an array "
                            "codec (no sub-chunks)")
        return int(codec.get_sub_chunk_count())

    def clay_repair_async(self, codec, lost: int, helpers,
                          planes: np.ndarray, trop=None) -> Future:
        """Layers-only helper planes [d, L, s] -> Future of the rebuilt
        chunk bytes [Z*s] (row order = helpers, layer order =
        ``codec.repair_layers(lost)``).  Repairs of the same lost shard
        from the same helpers coalesce along s into one repair."""
        self._check_array(codec)
        planes = np.ascontiguousarray(planes, dtype=np.uint8)
        d, L, s = planes.shape
        return self._submit(_Job(
            codec, planes.reshape(d * L, s), "crep",
            sig=(int(lost),) + tuple(int(h) for h in helpers), trop=trop))

    def clay_repair(self, codec, lost: int, helpers,
                    planes: np.ndarray) -> np.ndarray:
        return self.clay_repair_async(codec, lost, helpers,
                                      planes).result()

    def clay_decode_async(self, codec, available: Dict[int, np.ndarray],
                          trop=None) -> Future:
        """Survivor chunks {shard: [n]} -> Future of data planes [k, n]
        for an array codec.  Every survivor is kept (with d of them the
        codec repairs a single lost chunk from its repair layers), and
        jobs sharing the survivor signature coalesce along s."""
        Z = self._check_array(codec)
        sig = tuple(sorted(available))
        rows = [np.ascontiguousarray(available[i], dtype=np.uint8)
                .reshape(Z, -1) for i in sig]
        return self._submit(_Job(codec, np.concatenate(rows), "cdec",
                                 sig=sig, trop=trop))

    # -- worker -----------------------------------------------------------
    def _worker(self) -> None:
        stream = None
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(self.device)
        while True:
            job = self._q.get()
            if job is None:
                return
            batch = [job]
            cols = job.width
            # greedy coalescing: drain whatever is queued, waiting at most
            # one window for stragglers
            waited = False
            while cols < self.max_batch_cols:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    if waited:
                        break
                    waited = True
                    try:
                        nxt = self._q.get(timeout=self.window_s)
                    except queue.Empty:
                        break
                if nxt is None:
                    self._run_batch(batch, stream)
                    return
                if (nxt.codec is not batch[0].codec
                        or nxt.kind != batch[0].kind
                        or nxt.sig != batch[0].sig
                        or nxt.rows != batch[0].rows):
                    self._run_batch(batch, stream)
                    batch = [nxt]
                    cols = nxt.width
                    waited = False
                    continue
                batch.append(nxt)
                cols += nxt.width
            self._run_batch(batch, stream)

    def _run_batch(self, batch: List[_Job], stream) -> None:
        t_start = time.monotonic()
        for j in batch:
            self.perf.hinc("lat_encq_wait_us", (t_start - j.t_enq) * 1e6)
        # published before the failpoint, so a stalled dispatch shows
        # in the crash report's device section with its shapes
        self._inflight_info = {
            "kind": batch[0].kind, "jobs": len(batch),
            "shapes": [[j.rows, j.width] for j in batch], "t0": t_start}
        try:
            if fp.enabled("queue.batch.dispatch"):
                fp.failpoint("queue.batch.dispatch", jobs=len(batch),
                             kind=batch[0].kind)
            if stream is None:
                results = self._device_batch(batch)
            else:
                with torch.cuda.stream(stream):
                    results = self._device_batch(batch)
            t_compute = time.monotonic()
            for j, r in zip(batch, results):
                j.future.set_result(r)
        except BaseException as e:  # noqa: BLE001 — propagate to callers
            for j in batch:
                if not j.future.done():
                    j.future.set_exception(e)
            return
        finally:
            self._inflight_info = None
        kind = batch[0].kind
        self.stats.inc("staged_batches")
        self.stats.inc("h2d_bytes", sum(j.size for j in batch))
        self.batches += 1
        self.jobs += len(batch)
        self.batch_jobs[len(batch)] = self.batch_jobs.get(len(batch), 0) + 1
        if kind in ("dec", "cdec", "crep"):
            self.dec_batch_jobs[len(batch)] = (
                self.dec_batch_jobs.get(len(batch), 0) + 1)
        self.bytes_in += sum(j.rows * j.width for j in batch)
        t_done = time.monotonic()
        self.device_time_s += t_compute - t_start
        self.perf.hinc("lat_device_us", (t_compute - t_start) * 1e6)
        self.perf.hinc("lat_encq_dispatch_us", (t_done - t_compute) * 1e6)
        dw = devwatch.watch()
        dw.note_batch(kind, len(batch), [(j.rows, j.width) for j in batch],
                      t_compute - t_start)
        if dw.compile_activity_since(min(j.t_enq for j in batch)):
            self._blame_compile(dw, batch, t_compute)

    @staticmethod
    def _blame_compile(dw, batch: List[_Job], t_compute: float) -> None:
        """Annotate each op whose job waited on a compile (the kernel
        build or a first launch): the event ``compile_wait`` (timeline
        only, annotation=True) and its tracker's
        ``lat_compile_wait_us``."""
        for j in batch:
            if j.trop is None:
                continue
            wait = dw.compile_overlap_s(j.t_enq, t_compute)
            if wait <= 0:
                continue
            j.trop.mark_event("compile_wait", f"{wait * 1e3:.1f}ms",
                              annotation=True)
            trk = getattr(j.trop, "tracker", None)
            if trk is not None and trk.perf is not None:
                trk.perf.hinc("lat_compile_wait_us", wait * 1e6)

    def _upload(self, batch: List[_Job], slot) -> torch.Tensor:
        """Jobs' planes, job after job, into the upload slot; one copy
        to the device.  Returns the flat device buffer."""
        host = slot.arr.numpy()
        off = 0
        for j in batch:
            n = j.rows * j.width
            if isinstance(j.planes, np.ndarray):
                host[off:off + n] = j.planes.reshape(-1)
            else:
                for r, row in enumerate(j.planes):
                    host[off + r * j.width:off + (r + 1) * j.width] = row
            off += n
        return slot.arr.to(self.device, non_blocking=True)

    @staticmethod
    def _assemble(dst: torch.Tensor, flat: torch.Tensor,
                  batch: List[_Job]) -> None:
        """Lay the jobs side by side into dst [rows, P] on the device and
        zero the covering pad."""
        rows = dst.shape[0]
        col = fo = 0
        for j in batch:
            dst[:, col:col + j.width] = flat[fo:fo + rows * j.width].view(
                rows, j.width)
            col += j.width
            fo += rows * j.width
        if col < dst.shape[1]:
            dst[:, col:].zero_()

    def _device_batch(self, batch: List[_Job]) -> list:
        kind = batch[0].kind
        codec = batch[0].codec
        if codec.is_array:
            return self._array_batch(batch)
        mesh = (self.mesh if getattr(codec, "mds_recovery", False)
                else None)
        rows = batch[0].rows
        widths = [j.width for j in batch]
        total = sum(widths)
        offs = np.cumsum([0] + widths[:-1]).astype(np.int64)
        padded = shapebucket.covering(total, 1)
        slot = self._upload_pool.acquire(rows * total)
        try:
            flat = self._upload(batch, slot)
            if kind == "dec":
                x = torch.empty((rows, padded), dtype=torch.uint8,
                                device=self.device)
                self._assemble(x, flat, batch)
                rec, _bits = codec.recovery_matrix(list(batch[0].sig))
                if mesh is not None:
                    self.mesh_batches += 1
                    data = mesh.recovery_gather(rec, x, keep_device=True)
                else:
                    data = gf256.gf_matmul_bytes(rec, x, donate=True)
                host = data[:, :total].cpu().numpy()
                return [host[:, o:o + w] for o, w in zip(offs, widths)]
            m = codec.m
            full = torch.empty((rows + m, padded), dtype=torch.uint8,
                               device=self.device)
            self._assemble(full[:rows], flat, batch)
            if mesh is not None:
                self.mesh_batches += 1
                full[rows:].copy_(mesh.encode_scatter(
                    codec.coding_u8, full[:rows], keep_device=True))
            else:
                codec.encode_planes(full[:rows], out=full[rows:],
                                    jobs=(offs, widths))
            crcs = (crc32c_rows(full, offs, widths) if kind == "encp"
                    else None)
            coding = full[rows:, :total].cpu().numpy()
            outs = [coding[:, o:o + w] for o, w in zip(offs, widths)]
            if crcs is None:
                return outs
            return [(c, crcs[i]) for i, c in enumerate(outs)]
        finally:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self._upload_pool.release(slot)


    def _array_batch(self, batch: List[_Job]) -> list:
        """An array codec's batch (queue.py:332-410): the jobs' planes
        side by side along the sub-chunk byte axis of one [rows, per_row,
        s_pad] device tensor (per_row = Z for enc/encp, whose planes are
        [k, Z*s]; 1 for crep/cdec, whose rows already are sub-chunks),
        s_pad the covering bucket of the summed s; one codec call; each
        job's bytes taken back out of the one download."""
        kind = batch[0].kind
        codec = batch[0].codec
        Z = int(codec.get_sub_chunk_count())
        rows = batch[0].rows
        per_row = Z if kind in ("enc", "encp") else 1
        svec = [j.width // per_row for j in batch]
        offs = np.cumsum([0] + svec[:-1]).astype(np.int64)
        s_pad = shapebucket.covering(sum(svec), 1)
        slot = self._upload_pool.acquire(sum(j.rows * j.width
                                             for j in batch))
        try:
            flat = self._upload(batch, slot)
            extra = codec.m if kind in ("enc", "encp") else 0
            full = torch.empty((rows + extra, per_row, s_pad),
                               dtype=torch.uint8, device=self.device)
            x = full[:rows]
            fo = 0
            for o, s in zip(offs, svec):
                n = rows * per_row * s
                x[:, :, o:o + s] = flat[fo:fo + n].view(rows, per_row, s)
                fo += n
            if sum(svec) < s_pad:
                x[:, :, sum(svec):].zero_()
            if kind == "crep":
                lost, helpers = batch[0].sig[0], list(batch[0].sig[1:])
                out = codec.repair_planes(
                    lost, helpers, x.view(len(helpers), -1, s_pad))
                host = out.cpu().numpy()
                return [np.ascontiguousarray(host[:, o:o + s]).reshape(-1)
                        for o, s in zip(offs, svec)]
            if kind == "cdec":
                data = codec.decode_planes(list(batch[0].sig),
                                           x.view(-1, Z * s_pad))
                host = data.cpu().numpy().reshape(codec.k, Z, s_pad)
                return [np.ascontiguousarray(host[:, :, o:o + s]).reshape(
                    codec.k, -1) for o, s in zip(offs, svec)]
            codec.encode_planes(x.view(rows, Z * s_pad),
                                out=full[rows:].view(extra, Z * s_pad))
            host = full[rows:].cpu().numpy()
            outs = [np.ascontiguousarray(host[:, :, o:o + s]).reshape(
                extra, -1) for o, s in zip(offs, svec)]
            if kind == "enc":
                return outs
            # each job's k+m chunks in their own layout, side by side
            widths = [j.width for j in batch]
            lay = torch.empty((rows + extra, sum(widths)),
                              dtype=torch.uint8, device=self.device)
            bo = 0
            for o, s, w in zip(offs, svec, widths):
                lay[:, bo:bo + w].view(rows + extra, Z, s).copy_(
                    full[:, :, o:o + s])
                bo += w
            crcs = crc32c_rows(lay, np.cumsum([0] + widths[:-1]), widths)
            return [(c, crcs[i]) for i, c in enumerate(outs)]
        finally:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self._upload_pool.release(slot)


_defaults: Dict[str, StripeBatchQueue] = {}
_defaults_lock = threading.Lock()


def default_queue(device=None) -> StripeBatchQueue:
    """The process's queue for ``device`` (resolved: None is the card,
    and raises without one).  One queue per device, so a CPU run and a
    card run never share a worker, a pool or its counters."""
    dev = resolve_device(device)
    with _defaults_lock:
        q = _defaults.get(str(dev))
        if q is None:
            q = _defaults[str(dev)] = StripeBatchQueue(device=dev)
        return q


@atexit.register
def _stop_defaults() -> None:
    with _defaults_lock:
        queues = list(_defaults.values())
    for q in queues:
        q.stop(timeout=2.0)
