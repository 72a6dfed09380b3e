"""The device EC engine bench: pins, autotune, encode and decode sweeps,
small stripes, and the card's envelope.

    python -m ceph_tpu_torch.tools.ecbench [--target-s S] [--device DEV]

Port of ``bench.py``'s EC sections (``_ec_device`` :168-396,
``small_stripe_batched`` :482-602, ``envelope`` :88-161) and of
``tools/tpu_tune.py``'s tuning surface (:76-88), over the isa Cauchy
code k=8 m=4.  Prints one JSON line; where a key of the JAX bench means
the same thing it keeps its name.  Sections, in order:

1. pins: the planar (K1) and interleaved (K2) engines at T = 256 (1 MiB)
   against a host oracle, the GF(2^8) table product ``ec.gf.matmul``
   over ``mix32.mix_np`` data; a pin that fails raises;
2. autotune at T = 4096 (16 MiB) over {planar, inter} x tiles {128, 256,
   512, 1024} x mul_shift {False, True}; every variant must build and
   run (a failure raises).  Neither layout's grid depends on the tile
   on the card: the planar entry launches K1 and the interleaved one K2,
   which is K1's body with an interleaved index, each over one word per
   thread whatever the tile, so each layout's tile variants are one
   kernel timed several times (the sweep is kept: it is the JAX bench's
   surface, where the tile is the Pallas grid step).  ``xla_swar`` (the
   XLA graph engine) has no counterpart on the card and is recorded as
   such;
3. encode and decode sweeps at 1, 4, 16, 64 and 256 MiB, each layout
   with its best variant (so K1 and K2 are both timed at every size;
   the winner's rates carry the JAX keys), decode through the recovery
   matrix of survivors (0, 1, 2, 3, 4, 5, 8, 9) after a decode pin;
4. the 1 MiB host-path rate: ``gf256.gf_matmul_bytes`` with a full
   device -> host fetch per call;
5. small stripes: 4096 x 4 KiB objects through the port's
   ``StripeBatchQueue`` with a null codec (the machinery), end to end
   through ``encode_crc_async``, and the planar engine at the queue's
   recorded batch shapes;
6. envelope: the chained elementwise rate at 512 MB, the 1 MiB H2D rate
   from pinned and pageable memory, the bf16 matmul rate.

Rates are GB/s of object (data-plane) bytes per second, timed by the
calibrated loops of ``ops/benchloop.py`` (CUDA graphs between CUDA
events on the card; a graph holds at most ``max_iters`` = 65536
iterations, so the smallest rows may stop short of the target).  Each
loop iteration moves 2.0 bytes of device memory per object byte: the k
data planes read (1.0), the m coding planes written (0.5) and read
again by the digest (0.5).

On the card it runs by default and raises without one; ``--device cpu``
runs the plain versions on the CPU (the tests do, at small sizes).
There is no fallback: a CPU result names its device and leaves every
device-only figure "not measured".
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import gf, matrices
from ceph_tpu_torch.ec.codec import RSMatrixCodec
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.ops import benchloop, gf256, gf256_planes
from ceph_tpu_torch.ops.crc32c_device import crc32c_lanes_plain
from ceph_tpu_torch.ops.mix32 import mix_np

K, M = 8, 4
LANES = 128
PLANE_BYTES_PER_T = LANES * 4  # bytes of one plane per T-row
# (T, first iteration count) per sweep row: 1, 4, 16, 64, 256 MiB at k=8
SWEEP = ((256, 512), (1024, 256), (4096, 64), (16384, 16), (65536, 4))
TILES = (128, 256, 512, 1024)
PIN_T = 256      # 1 MiB object
TUNE_T = 4096    # 16 MiB object
SURVIVORS = (0, 1, 2, 3, 4, 5, 8, 9)  # lose data 6, 7 and coding 2, 3
LOOP_TRAFFIC = 2.0  # device bytes per object byte in one loop iteration
HBM_PEAK_GBPS = 3350.0  # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50_000_000   # H100 L2 cache (NVIDIA data sheet)
NOT_MEASURED = "not measured: cpu run"
XLA_NOT_ON_CARD = ("not on the card: the XLA graph engine (K4) has no "
                   "counterpart; its role is K1's dispatcher, ops/gf256.py")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"ecbench check failed: {what}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def oracle_encode(matrix: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The host oracle: GF(2^8) table product, uint8 [R, n]."""
    return gf.matmul(matrix, x).astype(np.uint8)


def planar_engine(matrix, tile: int, mul_shift: bool = False):
    def enc(w3, seed, out=None):
        return gf256_planes.encode_planes(matrix, w3, seed, tile=tile,
                                          mul_shift=mul_shift, out=out)
    return enc


def inter_engine(matrix, tile: int, mul_shift: bool = False):
    def enc(w3, seed, out=None):
        return gf256_planes.encode_planes_interleaved(
            matrix, w3, seed, tile=tile, mul_shift=mul_shift, out=out)
    return enc


# layout -> (engine factory(matrix, tile, mul_shift), interleaved?)
LAYOUTS = {"planar": (planar_engine, False), "inter": (inter_engine, True)}


def _host_planes(T: int) -> np.ndarray:
    """Host mirror of ``gen_planes(K, T)``: uint8 [K, T * 512]."""
    i = np.arange(K * T * LANES, dtype=np.uint32)
    return mix_np(i).view(np.uint8).reshape(K, -1)


def _to_host(words3: torch.Tensor, interleaved: bool) -> np.ndarray:
    if interleaved:
        words3 = words3.transpose(0, 1)
    return gf256_planes.unpack_planes(words3).cpu().numpy()


def ec_device(out: dict, dev: torch.device, *, sweep=SWEEP, tiles=TILES,
              pin_T: int = PIN_T, tune_T: int = TUNE_T,
              start_iters: int = 64, calib: dict,
              log: Callable[[str], None]) -> None:
    """Sections 1-4 into ``out``."""
    on_card = dev.type == "cuda"
    coding = np.ascontiguousarray(matrices.isa_cauchy(K, M), np.uint8)
    codec = RSMatrixCodec(K, M, coding, device=dev)
    require(pin_T % tiles[0] == 0 and all(tune_T % t == 0 for t in tiles),
            f"pin T={pin_T} is a multiple of tile {tiles[0]} and tune "
            f"T={tune_T} of every tile {tiles}")

    # ---- 1. pins, before any timing ----
    x_host = _host_planes(pin_T)
    want = oracle_encode(coding, x_host)
    w_pin = benchloop.gen_planes(K, pin_T, device=dev)
    w_pin_i = w_pin.transpose(0, 1).contiguous()
    pins = {}
    for name, (factory, inter) in LAYOUTS.items():
        got = factory(coding, tiles[0])(w_pin_i if inter else w_pin, 0)
        require(np.array_equal(_to_host(got, inter), want),
                f"{name} encode equals the host oracle")
        pins[name] = True
    out["ec_device_pinned"] = pins
    log(f"ecbench pins: {pins} at T={pin_T}")

    # ---- 2. autotune ----
    size_tune = tune_T * PLANE_BYTES_PER_T * K
    w_tune = {inter: benchloop.gen_planes(K, tune_T, inter, device=dev)
              for inter in (False, True)}
    cands = {}
    for layout, (factory, inter) in LAYOUTS.items():
        for tile in tiles:
            for ms in (False, True):
                name = f"{layout}_t{tile}" + ("_shift" if ms else "")
                cands[name] = (factory, tile, ms, inter)
    tune: dict = {"xla_swar": XLA_NOT_ON_CARD}
    detail = {}
    for name, (factory, tile, ms, inter) in cands.items():
        gbps, its, dt = benchloop.calibrated_rate(
            factory(coding, tile, ms), w_tune[inter], size_tune,
            start_iters=start_iters, **calib)
        tune[name] = gbps
        detail[name] = {"iters": its, "seconds": dt,
                        "ms_per_iter": dt / its * 1e3}
    del w_tune
    out["ec_engine_tune_gbps"] = tune
    out["ec_engine_tune_detail"] = detail
    out["ec_engine_tune_bytes"] = size_tune
    numeric = {k: v for k, v in tune.items() if isinstance(v, float)}
    winner = max(numeric, key=numeric.get)
    out["ec_engine"] = winner
    # each layout sweeps with its own best variant, so that K1 and K2
    # are both timed at every size; the winner's rows carry the JAX keys
    best = {layout: max((n for n in numeric
                         if n.startswith(layout + "_")), key=numeric.get)
            for layout in LAYOUTS}
    out["ec_engine_by_layout"] = best
    win_layout = next(lay for lay, n in best.items() if n == winner)
    log(f"ecbench tune at {size_tune >> 20} MiB: winner {winner}, best "
        f"per layout {best}")

    def engine_at(name, matrix, T):
        """(engine, tile): the variant, its tile cut to one dividing T."""
        factory, tile, ms, _ = cands[name]
        if T % tile:
            fits = [t for t in tiles if T % t == 0]
            require(bool(fits), f"a tile of {tiles} divides T={T}")
            tile = max(fits)
        return factory(matrix, tile, ms), tile

    rec, _ = codec.recovery_matrix(list(SURVIVORS))
    rec = np.ascontiguousarray(rec, dtype=np.uint8)
    surv = np.stack([x_host[s] if s < K else want[s - K] for s in SURVIVORS])
    surv_w = gf256_planes.pack_planes(torch.from_numpy(surv)).to(dev)

    # ---- 3. encode and decode sweeps, per layout ----
    rows = {str(T * PLANE_BYTES_PER_T * K): {"T": T} for T, _ in sweep}
    for layout, name in best.items():
        inter = LAYOUTS[layout][1]
        # decode pin: the recovery product rebuilds the pinned data
        sw = surv_w.transpose(0, 1).contiguous() if inter else surv_w
        dec = engine_at(name, rec, pin_T)[0](sw, 0)
        require(np.array_equal(_to_host(dec, inter), x_host),
                f"{layout} decode of the pinned batch equals its data")
        for T, start in sweep:
            size = T * PLANE_BYTES_PER_T * K
            w3 = benchloop.gen_planes(K, T, inter, device=dev)
            cell = {"variant": name}
            for what, matrix in (("encode", coding), ("decode", rec)):
                enc, cell["tile"] = engine_at(name, matrix, T)
                gbps, its, dt = benchloop.calibrated_rate(
                    enc, w3, size, start_iters=start, **calib)
                start = max(its // 2, 1)  # decode skips the ladder
                cell.update({f"{what}_gbps": gbps, f"{what}_iters": its,
                             f"{what}_ms_per_iter": dt / its * 1e3})
            del w3
            rows[str(size)].setdefault("layouts", {})[layout] = cell
    out["ec_decode_pinned"] = True
    for size, row in rows.items():
        cell = row["layouts"][win_layout]
        resident = int(size) * (K + M) // K < L2_BYTES
        row.update(
            encode_gbps=cell["encode_gbps"], decode_gbps=cell["decode_gbps"],
            timing=benchloop.loop_mode(dev), chip_resident_possible=resident,
            suspect=(NOT_MEASURED if not on_card else
                     (False if resident else
                      cell["encode_gbps"] * LOOP_TRAFFIC > HBM_PEAK_GBPS)))
    out["ec_sweep"] = rows
    first = rows[min(rows, key=int)]
    out["encode_gbps"] = first["encode_gbps"]
    out["decode_gbps"] = first["decode_gbps"]
    if str(64 << 20) in rows:
        out["encode_gbps_64mib"] = rows[str(64 << 20)]["encode_gbps"]
    stream = rows[max(rows, key=int)]
    out["encode_gbps_256mib_streaming"] = stream["encode_gbps"]
    out["encode_hbm_frac"] = (
        stream["encode_gbps"] * (K + M) / K / HBM_PEAK_GBPS if on_card
        else NOT_MEASURED)
    out["hbm_peak_gbps"] = HBM_PEAK_GBPS
    log("ecbench sweep (GB/s encode/decode per layout): " + "; ".join(
        f"{int(size) >> 20} MiB " + ", ".join(
            f"{lay} {c['encode_gbps']:.2f}/{c['decode_gbps']:.2f}"
            for lay, c in row["layouts"].items())
        for size, row in rows.items()))

    # ---- 4. host path: product + full device -> host fetch ----
    xd = torch.from_numpy(x_host).to(dev)
    gf256.gf_matmul_bytes(coding, xd).cpu()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        gf256.gf_matmul_bytes(coding, xd).cpu()
    dt = (time.perf_counter() - t0) / reps
    out["encode_1mib_host_path_gbps"] = x_host.nbytes / dt / 1e9
    out["encode_host_path_bytes"] = x_host.nbytes
    out["encode_1mib_host_path_note"] = "includes the device -> host fetch"


class _NullCodec:
    """The queue's codec surface with no product: part 1 times the
    queue's machinery (staging, upload, assembly, download, futures)."""

    k, m = K, M
    is_array = False

    def __init__(self) -> None:
        self.cols: list = []

    def encode_planes(self, planes, out=None, jobs=None):
        self.cols.append(planes.shape[1])
        return out


def _burst(submit, objs) -> float:
    t0 = time.perf_counter()
    for f in [submit(o) for o in objs]:
        f.result()
    return time.perf_counter() - t0


def small_stripe_batched(out: dict, dev: torch.device, *,
                         n_objs: int = 4096, min_T: int = 128,
                         start_iters: int = 64, calib: dict,
                         log: Callable[[str], None]) -> None:
    """Section 5: 4 KiB objects through the stripe-batch queue."""
    coding = np.ascontiguousarray(matrices.isa_cauchy(K, M), np.uint8)
    codec = RSMatrixCodec(K, M, coding, device=dev)
    rng = np.random.default_rng(1)
    objs = [rng.integers(0, 256, size=(K, 4096 // K), dtype=np.uint8)
            for _ in range(n_objs)]
    obj_bytes = n_objs * 4096

    # -- 1: machinery with a null codec (records the coalesced shapes)
    nc = _NullCodec()
    nq = StripeBatchQueue(device=dev)
    try:
        _burst(lambda o: nq.encode_async(nc, o), objs)
        nc.cols.clear()
        dt = _burst(lambda o: nq.encode_async(nc, o), objs)
    finally:
        nq.stop()
    out["small_stripe_4k_queue_machinery_gbps"] = obj_bytes / dt / 1e9
    batch_cols = sorted(set(nc.cols))
    out["small_stripe_queue_batch_cols"] = batch_cols[:8]

    # -- 2: end to end through encode_crc_async (warm burst first)
    q = StripeBatchQueue(device=dev)
    try:
        _burst(lambda o: q.encode_crc_async(codec, o), objs)
        futs = []
        t0 = time.perf_counter()
        for o in objs:
            futs.append(q.encode_crc_async(codec, o))
        res = [f.result() for f in futs]
        dt = time.perf_counter() - t0
    finally:
        q.stop()
    for i in (0, n_objs - 1):
        c, crcs = res[i]
        require(np.array_equal(c, oracle_encode(coding, objs[i])),
                f"small stripe {i}: coding equals the host oracle")
        shards = torch.from_numpy(np.concatenate([objs[i], c]))
        require(np.array_equal(crcs, crc32c_lanes_plain(
            shards, np.full(K + M, shards.shape[1])).numpy().astype(
                np.uint32)), f"small stripe {i}: CRCs of its shards")
    out["small_stripe_4k_batched_gbps"] = obj_bytes / dt / 1e9
    out["small_stripe_4k_elapsed_s"] = dt
    st = q.stats.snapshot()
    out["small_stripe_host_path"] = st["staged_batches"] == 0
    out["small_stripe_stats"] = {"batches": q.batches, "jobs": q.jobs,
                                 "bytes_in": q.bytes_in,
                                 "staged_batches": st["staged_batches"],
                                 "h2d_bytes": st["h2d_bytes"],
                                 "batch_jobs": dict(q.batch_jobs)}

    # -- 3: the planar engine at the queue's recorded batch shapes
    per_shape = {}
    for ncols in batch_cols:
        T = ncols // PLANE_BYTES_PER_T
        if ncols % PLANE_BYTES_PER_T or T < min_T:
            continue  # a residue batch below one tile rides the next
        w3 = benchloop.gen_planes(K, T, device=dev)
        gbps, _, _ = benchloop.calibrated_rate(
            planar_engine(coding, math.gcd(T, 128)), w3,
            T * PLANE_BYTES_PER_T * K, start_iters=start_iters, **calib)
        per_shape[str(ncols)] = gbps
    out["small_stripe_device_rate_per_batch_shape"] = per_shape
    out["small_stripe_4k_device_batched_gbps"] = (
        min(per_shape.values()) if per_shape else
        f"skipped: no coalesced batch reached T={min_T} "
        f"(shapes {batch_cols[:8]})")
    log(f"ecbench small stripes: machinery "
        f"{out['small_stripe_4k_queue_machinery_gbps']:.4f} GB/s, end to "
        f"end {out['small_stripe_4k_batched_gbps']:.4f} GB/s in "
        f"{q.batches} batches, device at batch shapes {per_shape}")


def envelope(out: dict, dev: torch.device, *, chained_bytes: int = 512 << 20,
             matmul_n: int = 4096, calib: dict,
             log: Callable[[str], None]) -> None:
    """Section 6: what the card itself sustains (``torch`` operators are
    fine here: they measure the card, not the port)."""
    env: dict = {"device": dev.type}
    a = torch.zeros(chained_bytes // 4, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)

    def make_chain(iters):
        def body():
            x, y = a, b
            for _ in range(iters):
                torch.mul(x, 1.000001, out=y)
                x, y = y, x
        return lambda: benchloop.device_seconds(body, dev)

    its, dt = benchloop.calibrate_loop(make_chain, start_iters=8, **calib)
    env["chained_elementwise_gbps"] = 2 * a.nbytes * its / dt / 1e9
    env["chained_elementwise_bytes"] = a.nbytes
    env["chained_iters"] = its
    del a, b

    if dev.type == "cuda":
        d = torch.empty(1 << 20, dtype=torch.uint8, device=dev)
        for kind, h in (("pinned", torch.zeros(1 << 20, dtype=torch.uint8,
                                               pin_memory=True)),
                        ("pageable", torch.zeros(1 << 20,
                                                 dtype=torch.uint8))):
            d.copy_(h)
            torch.cuda.synchronize(dev)
            reps = 50
            t0 = time.perf_counter()
            for _ in range(reps):
                d.copy_(h, non_blocking=True)
                torch.cuda.synchronize(dev)
            env[f"h2d_1mib_{kind}_mbps"] = (
                h.nbytes * reps / (time.perf_counter() - t0) / 1e6)
    else:
        env["h2d_1mib_pinned_mbps"] = NOT_MEASURED
        env["h2d_1mib_pageable_mbps"] = NOT_MEASURED

    n = matmul_n
    x = torch.full((n, n), 0.001, dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(x)

    def make_mm(iters):
        def body():
            for _ in range(iters):
                torch.matmul(x, x, out=y)
        return lambda: benchloop.device_seconds(body, dev)

    its, dt = benchloop.calibrate_loop(make_mm, start_iters=8, **calib)
    env["matmul_bf16_tflops"] = 2 * n ** 3 * its / dt / 1e12
    env["matmul_n"] = n
    env["matmul_iters"] = its
    out["envelope"] = env
    log(f"ecbench envelope: {env}")


def run(device=None, *, sweep=SWEEP, tiles=TILES, pin_T: int = PIN_T,
        tune_T: int = TUNE_T, target_s: float = 0.5, cap_s: float = 10.0,
        max_iters: int = 1 << 16, start_iters: int = 64,
        small_objs: int = 4096, small_min_T: int = 128,
        envelope_bytes: int = 512 << 20,
        matmul_n: int = 4096,
        log: Optional[Callable[[str], None]] = None) -> dict:
    """Every section on ``device`` (None: the CUDA card, raising without
    one); returns the result dictionary."""
    dev = resolve_device(device)
    log = log or (lambda msg: None)
    out: dict = {"device": {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": torch.cuda.device_count() if dev.type == "cuda" else 0}}
    if dev.type == "cuda":
        out["card"] = card_line()
    out["timing"] = benchloop.loop_mode(dev)
    out["loop_traffic_bytes_per_object_byte"] = LOOP_TRAFFIC
    calib = {"target_s": target_s, "cap_s": cap_s, "max_iters": max_iters}
    out["calibration"] = dict(calib)
    t0 = time.perf_counter()
    ec_device(out, dev, sweep=sweep, tiles=tiles, pin_T=pin_T,
              tune_T=tune_T, start_iters=start_iters, calib=calib, log=log)
    small_stripe_batched(out, dev, n_objs=small_objs, min_T=small_min_T,
                         start_iters=start_iters, calib=calib, log=log)
    envelope(out, dev, chained_bytes=envelope_bytes, matmul_n=matmul_n,
             calib=calib, log=log)
    out["elapsed_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--target-s", type=float, default=0.5,
                    help="seconds one calibrated call should reach")
    args = ap.parse_args(argv)
    res = run(args.device, target_s=args.target_s,
              log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
