"""StripeBatchQueue — coalesce concurrent EC encodes and decodes into
one device batch.

Port of ``ceph_tpu/tpu/queue.py`` for the flat codecs (RS and the GF(2)
bit-matrix techniques), kinds ``enc`` (coding planes), ``encp`` (coding
planes + per-shard CRC-32C) and ``dec`` (data planes rebuilt from k
survivors, for codecs whose recovery is one MDS matrix product: the RS
codecs; a bit-matrix code or shec decodes through ``codec.decode``).
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

1. the jobs' planes are copied job after job into one pinned staging
   slot and cross host -> device in ONE copy;
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
(``gpu/devwatch.py``).  (The clay kinds ``cdec`` and ``crep`` and the
mesh path come with later slices.)
"""

from __future__ import annotations

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

# one slot holds a full coalesced batch of the 1 MiB-stripe config
# (k=8 x 1 Mi columns); a larger batch gets a pinned buffer of its own
STAGING_SLOT_BYTES = 16 << 20
STAGING_SLOTS = 2


class _Job:
    __slots__ = ("codec", "planes", "rows", "width", "kind", "sig", "size",
                 "t_enq", "future")

    def __init__(self, codec, planes: Sequence[np.ndarray], kind: str,
                 sig: Tuple[int, ...] = (), size: int = 0) -> None:
        self.codec = codec
        self.planes = planes        # rows x width host uint8 (2-D or list)
        self.rows = len(planes)
        self.width = int(len(planes[0])) if self.rows else 0
        self.kind = kind            # "enc" | "encp" | "dec"
        self.sig = sig              # dec: survivor ids
        self.size = size or self.rows * self.width  # real payload bytes
        self.t_enq = time.monotonic()
        self.future: Future = Future()


def _host_rows(rows, width: int) -> List[np.ndarray]:
    out = [np.ascontiguousarray(r, dtype=np.uint8).reshape(-1) for r in rows]
    if any(r.size != width for r in out):
        raise ValueError("every plane of a job needs the same width")
    return out


class StripeBatchQueue:
    def __init__(self, device=None, max_batch_cols: int = 1 << 20,
                 window_s: float = 0.0005) -> None:
        self.device = resolve_device(device)
        self.max_batch_cols = max_batch_cols
        self.window_s = window_s
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
        self.stats = DevPathStats()
        self.pool = StagingPool(slot_bytes=STAGING_SLOT_BYTES,
                                slots=STAGING_SLOTS,
                                pin=self.device.type == "cuda",
                                stats=self.stats)
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

    def encode_async(self, codec, planes: np.ndarray) -> Future:
        """planes uint8 [k, n] -> Future of coding planes [m, n]."""
        self._check_encodes(codec)
        planes = np.ascontiguousarray(planes, dtype=np.uint8)
        return self._submit(_Job(codec, planes, "enc"))

    def encode(self, codec, planes: np.ndarray) -> np.ndarray:
        return self.encode_async(codec, planes).result()

    def encode_crc_async(self, codec, planes: np.ndarray,
                         size: int = 0) -> Future:
        """Fused encode + per-shard crc32c: planes uint8 [k, n] ->
        Future of (coding [m, n], crcs u32 [k+m]).  Only the coding
        planes and the 4-byte digests come back to the host."""
        self._check_encodes(codec)
        planes = np.ascontiguousarray(planes, dtype=np.uint8)
        return self._submit(_Job(codec, planes, "encp", size=size))

    def decode_data_async(self, codec,
                          available: Dict[int, np.ndarray]) -> Future:
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
        return self._submit(_Job(codec, rows, "dec", sig=sig))

    def decode_data(self, codec, available) -> np.ndarray:
        return self.decode_data_async(codec, available).result()

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
        kind = batch[0].kind
        self.stats.inc("staged_batches")
        self.stats.inc("h2d_bytes", sum(j.size for j in batch))
        self.batches += 1
        self.jobs += len(batch)
        self.batch_jobs[len(batch)] = self.batch_jobs.get(len(batch), 0) + 1
        if kind == "dec":
            self.dec_batch_jobs[len(batch)] = (
                self.dec_batch_jobs.get(len(batch), 0) + 1)
        self.bytes_in += sum(j.rows * j.width for j in batch)
        t_done = time.monotonic()
        self.device_time_s += t_compute - t_start
        self.perf.hinc("lat_device_us", (t_compute - t_start) * 1e6)
        self.perf.hinc("lat_encq_dispatch_us", (t_done - t_compute) * 1e6)
        devwatch.watch().note_batch(kind, len(batch),
                                    [(j.rows, j.width) for j in batch],
                                    t_compute - t_start)

    def _upload(self, batch: List[_Job], slot) -> torch.Tensor:
        """Jobs' planes, job after job, into the staging slot; one copy
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
        rows = batch[0].rows
        widths = [j.width for j in batch]
        total = sum(widths)
        offs = np.cumsum([0] + widths[:-1]).astype(np.int64)
        padded = shapebucket.covering(total, 1)
        slot = self.pool.acquire(rows * total)
        try:
            flat = self._upload(batch, slot)
            if kind == "dec":
                x = torch.empty((rows, padded), dtype=torch.uint8,
                                device=self.device)
                self._assemble(x, flat, batch)
                rec, _bits = codec.recovery_matrix(list(batch[0].sig))
                data = gf256.gf_matmul_bytes(rec, x, donate=True)
                host = data[:, :total].cpu().numpy()
                return [host[:, o:o + w] for o, w in zip(offs, widths)]
            m = codec.m
            full = torch.empty((rows + m, padded), dtype=torch.uint8,
                               device=self.device)
            self._assemble(full[:rows], flat, batch)
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
            self.pool.release(slot)
