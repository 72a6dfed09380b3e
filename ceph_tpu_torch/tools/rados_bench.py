"""rados bench — cluster IO benchmark through the client library.

Port of ``tools/rados_bench.py``: the same ``ObjBencher`` and report,
over the port's ``IoCtx``.  Reference: `rados -p <pool> bench <seconds>
write|seq|rand -t N -b S` over ObjBencher (src/common/obj_bencher.h:
64-112): timed concurrent object writes, then sequential/random reads
of what was written, reporting ops/s, MB/s and latency.  ``--selftest``
spins an in-process cluster of the port's daemons
(``tests/torch_daemon_harness.py``'s ``DaemonCluster`` and
``LibClient``) on ``--device``: the card unless ``--device cpu`` asks
for the plain versions, and without a card and without ``--device`` the
tool raises before any daemon starts.

    python -m ceph_tpu_torch.tools.rados_bench 2 seq --selftest -p 2
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

from ceph_tpu_torch.device import resolve_device


class ObjBencher:
    """The obj_bencher role over an IoCtx."""

    def __init__(self, ioctx, prefix: str = "benchmark_data") -> None:
        self.io = ioctx
        self.prefix = prefix
        self.written: list = []

    def _run(self, seconds: float, threads: int, fn) -> dict:
        stop = time.monotonic() + seconds
        lock = threading.Lock()
        stats = {"ops": 0, "bytes": 0, "lat_sum": 0.0, "lat_max": 0.0,
                 "errors": 0}

        def worker(wid: int) -> None:
            i = 0
            while time.monotonic() < stop:
                t0 = time.monotonic()
                try:
                    n = fn(wid, i)
                except Exception:
                    with lock:
                        stats["errors"] += 1
                    continue
                dt = time.monotonic() - t0
                with lock:
                    stats["ops"] += 1
                    stats["bytes"] += n
                    stats["lat_sum"] += dt
                    stats["lat_max"] = max(stats["lat_max"], dt)
                i += 1

        ts = [threading.Thread(target=worker, args=(w,))
              for w in range(threads)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.monotonic() - t0
        ops = stats["ops"]
        return {
            "seconds": round(wall, 3),
            "total_ops": ops,
            "total_mb": round(stats["bytes"] / (1 << 20), 3),
            "ops_per_sec": round(ops / wall, 2) if wall else 0,
            "mb_per_sec": round(stats["bytes"] / (1 << 20) / wall, 3)
            if wall else 0,
            "avg_latency_s": round(stats["lat_sum"] / ops, 5) if ops else 0,
            "max_latency_s": round(stats["lat_max"], 5),
            "errors": stats["errors"],
        }

    def write(self, seconds: float, threads: int, size: int) -> dict:
        payload = bytes(random.getrandbits(8) for _ in range(min(size, 256)))
        payload = (payload * (size // len(payload) + 1))[:size]
        self.written = []
        lock = threading.Lock()

        def do(wid, i):
            oid = f"{self.prefix}_{wid}_{i}"
            self.io.write_full(oid, payload)
            with lock:
                self.written.append(oid)
            return size

        out = self._run(seconds, threads, do)
        out["op"] = "write"
        return out

    def _read(self, seconds, threads, rand: bool) -> dict:
        names = list(self.written)
        if not names:
            raise SystemExit("nothing written; run write first")

        def do(wid, i):
            oid = (random.choice(names) if rand
                   else names[(wid + i * 7) % len(names)])
            return len(self.io.read(oid))

        out = self._run(seconds, threads, do)
        out["op"] = "rand" if rand else "seq"
        return out

    def seq(self, seconds, threads):
        return self._read(seconds, threads, rand=False)

    def rand(self, seconds, threads):
        return self._read(seconds, threads, rand=True)

    def cleanup(self) -> None:
        for oid in self.written:
            try:
                self.io.remove(oid)
            except Exception:
                pass


def _harness():
    """``tests/torch_daemon_harness.py`` of this checkout."""
    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_daemon_harness

    return torch_daemon_harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rados-bench")
    p.add_argument("seconds", type=float)
    p.add_argument("mode", choices=["write", "seq", "rand"])
    p.add_argument("-p", "--pool", type=int, default=1)
    p.add_argument("-t", "--threads", type=int, default=16)
    p.add_argument("-b", "--block-size", type=int, default=4 << 20)
    p.add_argument("--selftest", action="store_true",
                   help="run against an in-process mini cluster")
    p.add_argument("--no-cleanup", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    args = p.parse_args(argv)

    if not args.selftest:
        print("only --selftest wiring is bundled; pass a monmap via the "
              "library for a live cluster", file=sys.stderr)
        return 1

    # resolved first: without a card and without --device this raises
    # before a daemon or a thread starts
    device = resolve_device(args.device)
    H = _harness()
    cluster = H.DaemonCluster("ceph_tpu_torch", device=device)
    client = H.LibClient(cluster)
    try:
        b = ObjBencher(client.rc.ioctx(args.pool))
        out = b.write(args.seconds, args.threads, args.block_size)
        print(json.dumps(out, indent=1))
        if args.mode in ("seq", "rand"):
            out = getattr(b, args.mode)(args.seconds, args.threads)
            print(json.dumps(out, indent=1))
        if not args.no_cleanup:
            b.cleanup()
    finally:
        client.shutdown()
        cluster.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
