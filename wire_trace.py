#!/usr/bin/env python3
"""Where the ``wire`` and ``recovery`` phases' time goes:
``chip_smoke.run_wire`` at full width, once plain and once traced, then
the host CRC-32C's aggregate rate from 1 and 4 threads.

    python3 wire_trace.py

It needs a CUDA card and builds the kernels as ``chip_smoke.py`` does.
The traced run splits each of ``run_wire``'s three windows (the
``WRITEFULL`` MOSDOps through ``PG.do_op``, ``ECBackend.submit`` and
its MECSubWriteVec fan-out; the degraded ``READ`` MOSDOps through
``_ec_read_object``, its MECSubRead messages and ``reconstruct_async``,
one ``run_threads`` call each; and the recovery step,
``PG.recovery_engine().recover`` of the primary's lost shards) into:

- the host CRC by call site: the frame CRC on send (``_frame_of``) and
  on receive (``_read_one``), the store's seals on write
  (``_seal_rebuild``) and on read (``_verify_extents``), the backend's
  hinfo CRC on write (``_hinfo``: none, the card's CRC stands in) and
  its hinfo check of each shard it reads (``read_local_chunk2``);
  calls, bytes, seconds in the calls summed over threads, and the
  thread CPU seconds of those calls (the rest of a call is time its
  thread did not run: the interpreter lock, or no free core);
- the process's CPU seconds over the wall (cores kept busy);
- where the threads are: every 5 ms a sampler reads each thread's
  innermost frames and counts them by thread group (primary loop, peer
  loops, the peers' dispatch threads, the writer or reader threads,
  the primary's op threads, the queue's worker, the backend's one
  fan-out thread, the decode completions) and by what the thread does
  (CRC, message codec with the OSD messages and the PG log, staging,
  store, messenger, PG, backend, waiting on a lock, a staging slot or an
  op's reply, idle);
- on the card: kernel and copy intervals from ``torch.profiler``, merged,
  over the wall (the card's idle share is one less that).

The plain run's walls against the traced run's give the cost of the
tracing.  The last line printed is one JSON object with everything."""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

import chip_smoke

MiB = 1 << 20
SAMPLE_S = 0.005
CRC_SITES = {"_frame_of": "frame out", "_read_one": "frame in",
             "_seal_rebuild": "seal write", "_verify_extents": "seal verify",
             "_hinfo": "hinfo write", "read_local_chunk2": "hinfo verify"}
CRC_TOTAL = 48 * MiB                 # bytes per thread-scaling probe
CRC_PIECES = (64 << 10, 1536 << 10)  # an extent seal; a sub-write's frame
CRC_THREADS = (1, 4)
# modules a waiting thread passes through on its way to the wait
_WAIT_FILES = ("threading.py", "queue.py", "concurrent/futures/_base.py")


def thread_group(name: str) -> str:
    if name.startswith("msgr-client"):
        return "primary loop"
    if name.startswith("msgr-"):
        return "peer loops"
    if name.startswith("asyncio"):
        return "dispatch threads"
    if name == "stripe-batch":
        return "queue worker"
    if name.startswith("pg-fanout"):
        return "fan-out thread"
    if name.startswith("osd0-op"):
        return "op threads"
    if name.startswith("ec-decode-done"):
        return "decode completions"
    if "(worker)" in name:
        return "writer/reader threads"
    return "other"


def _where(frame) -> tuple:
    code = frame.f_code
    return code.co_filename.replace(os.sep, "/"), code.co_name


def _repo_module(path: str):
    """The module of the repo's own code that ``path`` is, else None."""
    if "/ceph_tpu_torch/" in path:
        return path.split("/ceph_tpu_torch/", 1)[1]
    if path.endswith(("chip_smoke.py", "wire_trace.py")):
        return os.path.basename(path)
    return None


def _in_wait(path: str) -> bool:
    """Whether ``path`` is the standard library's waiting or the port's
    lockdep (a lock's acquire)."""
    if path.endswith("/ceph_tpu_torch/core/lockdep.py"):
        return True
    return _repo_module(path) is None and path.endswith(_WAIT_FILES)


def activity(frame) -> str:
    """What a thread whose innermost Python frame is ``frame`` does: a
    wait or an idle loop by where it waits, else the innermost frame of
    the repo's own code (numpy's and torch's Python wrappers count for
    the code that called them)."""
    path, name = _where(frame)
    if path.endswith("selectors.py"):
        return "idle: event loop"
    if path.endswith("concurrent/futures/thread.py") and name == "_worker":
        return "idle: thread pool"
    if _in_wait(path):
        f = frame
        while f is not None and _in_wait(_where(f)[0]):
            f = f.f_back
        if f is None:
            return "wait: thread start or end"
        path, name = _where(f)
        if path.endswith("concurrent/futures/thread.py"):
            return "idle: thread pool"
        if path.endswith("chip_smoke.py"):
            return ("wait: op reply" if name == "call"
                    else "wait: phase code")
        if path.endswith("/gpu/staging.py"):
            return "wait: staging slot"
        if "/gpu/" in path:
            return "idle: queue worker"
        if "/store/" in path or "/msg/" in path:
            return "wait: store or messenger lock"
        if "/osd/" in path:
            return "wait: PG or backend lock"
        return f"wait: {os.path.basename(path)}:{name}"
    f = frame
    while f is not None and _repo_module(_where(f)[0]) is None:
        f = f.f_back
    if f is None:
        return f"other: {os.path.basename(path)}:{name}"
    mod = _repo_module(_where(f)[0])
    if mod == "core/crc.py":
        return "crc"
    if mod in ("core/encoding.py", "msg/message.py", "osd/messages.py",
               "osd/pglog.py", "osd/types.py"):
        return "message codec"
    if mod == "gpu/staging.py":
        return "staging"
    if mod.startswith("store/"):
        return "store"
    if mod == "osd/pg.py":
        return "PG"
    if mod in ("osd/backend.py", "osd/recovery.py", "osd/ecutil.py"):
        return "backend"
    if mod == "msg/messenger.py":
        return "messenger"
    if mod == "chip_smoke.py":
        return "phase code"
    if mod == "wire_trace.py":
        return "tracing"
    return "queue and kernels"


def merged_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals, in ms."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def trace(torch, dev, **wire) -> dict:
    """``chip_smoke.run_wire(torch, dev, **wire)`` with the host CRC's
    call sites timed, a frame sampler running and, on a CUDA device,
    ``torch.profiler`` over each window.  Returns ``run_wire``'s result
    with ``windows``: one dict per ``run_threads`` call, and one for the
    recovery step, which runs only when ``wire`` asks for it
    (``recover=True``)."""
    wire.setdefault("recover", False)
    from ceph_tpu_torch.core import crc as hcrc
    from ceph_tpu_torch.msg import messenger
    from ceph_tpu_torch.osd import backend
    from ceph_tpu_torch.store import objectstore

    windows = []
    state = {"win": None}
    acc_lock = threading.Lock()
    plain_crc = hcrc.crc32c

    def timed_crc(data, crc=0):
        t0, c0 = time.perf_counter(), time.thread_time()
        try:
            return plain_crc(data, crc)
        finally:
            dt, dc = time.perf_counter() - t0, time.thread_time() - c0
            site = CRC_SITES.get(sys._getframe(1).f_code.co_name, "other")
            win = state["win"]
            if win is not None:
                with acc_lock:
                    row = windows[win]["crc"].setdefault(site, [0, 0, 0., 0.])
                    row[0] += 1
                    row[1] += memoryview(data).nbytes
                    row[2] += dt
                    row[3] += dc

    stop = threading.Event()

    def sampler():
        me = threading.get_ident()
        while not stop.wait(SAMPLE_S):
            win = state["win"]
            if win is None:
                continue
            names = {t.ident: t.name for t in threading.enumerate()}
            counts = windows[win]["samples"]
            for tid, frame in sys._current_frames().items():
                if tid == me or tid == main_id:
                    continue
                key = (f"{thread_group(names.get(tid, ''))} / "
                       f"{activity(frame)}")
                counts[key] = counts.get(key, 0) + 1

    on_card = dev.type == "cuda"
    plain_run_threads = chip_smoke.run_threads

    def windowed(fn, *args):
        """fn(*args) as one window; returns (fn's result, wall s)."""
        w = {"crc": {}, "samples": {}}
        prof = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        windows.append(w)
        state["win"] = len(windows) - 1
        cpu0, t0 = time.process_time(), time.monotonic()
        try:
            out = fn(*args)
        finally:
            wall = time.monotonic() - t0
            state["win"] = None
            w["cpu_s"] = time.process_time() - cpu0
            if prof is not None:
                prof.stop()
        w["wall_s"] = wall
        if prof is not None:
            dev_evs = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            copies = [(e.time_range.start, e.time_range.end) for e in dev_evs
                      if e.name.startswith(("Memcpy", "Memset"))]
            kernels = [(e.time_range.start, e.time_range.end) for e in dev_evs
                       if not e.name.startswith(("Memcpy", "Memset"))]
            w["device"] = {"kernels": len(kernels), "copies": len(copies),
                           "kernel_ms": merged_ms(kernels),
                           "copy_ms": merged_ms(copies),
                           "busy_ms": merged_ms(kernels + copies)}
        return out, wall

    def traced_run_threads(fn, nobj, threads):
        return windowed(plain_run_threads, fn, nobj, threads)[1]

    plain_recover = chip_smoke._recover_primary

    def traced_recover(*args):
        return windowed(plain_recover, *args)[0]

    if on_card:  # the profiler's first start is slow: not in a window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
    main_id = threading.get_ident()
    th = threading.Thread(target=sampler, name="wire-trace-sampler",
                          daemon=True)
    messenger.crc32c = objectstore.crc32c = backend.crc32c = timed_crc
    chip_smoke.run_threads = traced_run_threads
    chip_smoke._recover_primary = traced_recover
    th.start()
    try:
        res = chip_smoke.run_wire(torch, dev, **wire)
    finally:
        stop.set()
        th.join()
        chip_smoke.run_threads = plain_run_threads
        chip_smoke._recover_primary = plain_recover
        messenger.crc32c = objectstore.crc32c = backend.crc32c = plain_crc
    for w in windows:
        w["crc_s"] = sum(r[2] for r in w["crc"].values())
        w["crc_cpu_s"] = sum(r[3] for r in w["crc"].values())
        w["crc"] = {site: dict(zip(("calls", "bytes", "s", "cpu_s"), r))
                    for site, r in w["crc"].items()}
        w["samples"] = dict(sorted(w["samples"].items(),
                                   key=lambda kv: -kv[1]))
        if "device" in w:
            w["device"]["idle_share"] = 1 - w["device"]["busy_ms"] / (
                w["wall_s"] * 1e3)
    res["windows"] = windows
    return res


def crc_rates() -> dict:
    """The host CRC-32C's aggregate rate (MB/s, best of 3) over
    ``CRC_TOTAL`` seeded bytes cut into pieces of each of ``CRC_PIECES``
    bytes and shared out among each count of ``CRC_THREADS``."""
    from ceph_tpu_torch.core.crc import crc32c

    buf = np.random.default_rng(chip_smoke.SEED).integers(
        0, 256, CRC_TOTAL, np.uint8)
    mv = memoryview(buf)
    rates = {}
    for piece in CRC_PIECES:
        crc32c(mv[:piece])  # the combine's shift tables for this size
        for nt in CRC_THREADS:
            share = CRC_TOTAL // nt

            def work(t):
                for o in range(t * share, (t + 1) * share, piece):
                    crc32c(mv[o:o + piece])

            best = min(chip_smoke.run_threads(work, nt, nt)
                       for _ in range(3))
            rates[f"{piece >> 10} KiB x {nt}"] = CRC_TOTAL / best / 1e6
    return rates


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wire_trace: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from ceph_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.lib()
    plain = chip_smoke.run_wire(torch, dev)
    traced = trace(torch, dev, recover=True)
    rates = crc_rates()
    out = {"card": card,
           "plain": {"w_wall": plain["w_wall"], "r_wall": plain["r_wall"],
                     "rec_wall": plain["recovery"]["wall"]},
           "traced": {"w_wall": traced["w_wall"], "r_wall": traced["r_wall"],
                      "rec_wall": traced["recovery"]["wall"],
                      "windows": traced["windows"]},
           "crc_mbs": rates}
    plain_walls = (plain["w_wall"], plain["r_wall"],
                   plain["recovery"]["wall"])
    for name, w, pw in zip(("write", "read", "recovery"), traced["windows"],
                           plain_walls):
        n = sum(w["samples"].values())
        top = ", ".join(f"{k} {v / n:.3f}" for k, v in
                        list(w["samples"].items())[:12])
        print(f"[{card}] {name}: wall {w['wall_s']:.3f} s (plain "
              f"{pw:.3f} s), CPU {w['cpu_s']:.3f} s; "
              f"host CRC {w['crc_s']:.3f} s in calls, {w['crc_cpu_s']:.3f} "
              f"s CPU, by site {w['crc']}; card {w.get('device')}; "
              f"samples {n}: {top}", flush=True)
    print(f"[{card}] host CRC MB/s by piece and threads {rates}", flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
