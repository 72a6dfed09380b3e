"""Shape-bucket ABI: the declared launch surface of every kernel family.

Port of ``ceph_tpu/tpu/shapebucket.py``.  The reference declares, for
each XLA/Pallas kernel family, the finite set of shapes it may be asked
to compile, pads every dispatch up to a covering bucket
(:func:`covering`), and compiles the declared buckets at daemon boot
(:class:`DeviceWarmup`) so no op waits on a compile.

The port's kernels are hand-written CUDA, built once per checkout from
``ceph_tpu_torch/csrc`` into ``ceph_tpu_torch/_build/`` (``ops/_build.py``)
and launched at any shape without a recompile.  What carries over:

- the covering grammar (:func:`covering`, :func:`odd_part`): the
  stripe-batch queue pads every batch's width with it, so the widths
  the card sees stay few;
- the declarations (:class:`BucketSpec`, :func:`declare`,
  :func:`sig_declared`): the kernel families the device watch keys its
  compile table by (``gf256_matmul``, ``gf256_interleaved``,
  ``crc32c_rows``, ``crush_rule``, ``gf2_matmul``, ``gf2_xor``,
  ``mesh_digest`` and the build, ``kernel_build``), each over the
  signature its wrapper passes to ``devwatch.instrumented_launch``; and
  the batch surface of the queue's kinds ``enc``, ``encp``, ``dec``,
  ``crep`` and ``cdec``, of K1 inside clay ``gf256_clay`` and of the
  mesh's programs ``meshio``;
- :class:`DeviceWarmup`: on the card, "warm" means the one kernel build
  plus a first launch of each kernel at each signature a pool's writes
  and degraded reads launch at each warmed width, so the first client
  op pays neither.  Each plan item is one launch: K1 through the codec's
  ``encode_planes`` (what an ``enc`` or ``encp`` batch launches) and the
  recovery product (``dec``), or for clay its ``repair_planes`` and
  ``decode_planes``, the CRC kernel through ``crc32c_rows`` over the
  [k+m, width] batch an ``encp`` batch reads, and K6 through
  ``OSDMap.map_pgs`` (one launch a pool) and one ``pg_to_up_acting``
  a pool (the one-id walk of the objecter and the daemons).

:meth:`DeviceWarmup.run` runs under the device watch's
``warmup_scope``, so its first launches class as ``warmup``, and
publishes its stats as the watch's ``warmup_stats``.  The reference's
persistent XLA compile cache has no counterpart: :func:`setup_compile_cache`
records the directory it is given and returns False.  Its role, the
build a later process need not pay, is the kernel build's: a process
that loads the library ``ops/_build.py`` left in
``ceph_tpu_torch/_build/`` is the watch's ``note_persist(hit=True)``
(the reference's ``_on_jax_event``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ceph_tpu_torch.core.lockdep import make_lock

# ---------------------------------------------------------------------------
# Covering buckets: the one padding helper every dispatch site uses
# ---------------------------------------------------------------------------


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    n = int(n)
    return 1 << max(0, (n - 1).bit_length())


def odd_part(n: int) -> int:
    """n with every factor of two divided out (0 -> 0)."""
    n = int(n)
    return n // (n & -n) if n else 0


def covering(n: int, gran: int = 1, floor: int = 1) -> int:
    """The smallest ``gran * 2**j`` that is >= both ``n`` and ``floor``."""
    gran = max(1, int(gran))
    units = -(-max(int(n), 1) // gran)  # ceil
    return max(int(floor), gran * round_up_pow2(units))


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

class BucketSpec:
    """One family's declared surface.  A dimension is declared when it
    is static geometry (``<= small_max``) or a ladder rung ``odd * 2**j``
    with ``odd <= odd_max`` up to ``ceiling`` (what :func:`covering`
    produces); ``free_args`` exempts argument positions sized by the map
    epoch rather than the call."""

    __slots__ = ("family", "small_max", "odd_max", "ceiling",
                 "free_args", "note")

    def __init__(self, family: str, *, small_max: int = 64,
                 odd_max: int = 63, ceiling: int = 1 << 26,
                 free_args: Tuple[int, ...] = (), note: str = "") -> None:
        self.family = family
        self.small_max = int(small_max)
        self.odd_max = int(odd_max)
        self.ceiling = int(ceiling)
        self.free_args = tuple(free_args)
        self.note = note

    def dim_declared(self, dim: int) -> bool:
        dim = int(dim)
        if dim <= self.small_max:
            return True
        return dim <= self.ceiling and odd_part(dim) <= self.odd_max

    def atom_declared(self, atom: Tuple, pos: int) -> bool:
        """One signature atom, ``("arr", dtype, shape)`` for an array
        argument, against this spec.  Non-array atoms are always
        declared."""
        if len(atom) == 3 and atom[0] == "arr":
            if pos in self.free_args:
                return True
            shape = atom[2]
            if not isinstance(shape, tuple):
                return False  # symbolic dims: not a declared bucket
            return all(self.dim_declared(d) for d in shape)
        return True

    def sig_declared(self, sig: Tuple) -> bool:
        for pos, atom in enumerate(sig):
            if len(atom) == 2 and isinstance(atom[0], str) \
                    and isinstance(atom[1], tuple):
                # kwarg pair (name, atom)
                if not self.atom_declared(atom[1], pos):
                    return False
            elif not self.atom_declared(atom, pos):
                return False
        return True


_REGISTRY: Dict[str, BucketSpec] = {}


def declare(family: str, **kw) -> BucketSpec:
    spec = BucketSpec(family, **kw)
    _REGISTRY[family] = spec
    return spec


def get_spec(family: str) -> Optional[BucketSpec]:
    return _REGISTRY.get(family)


def declared_families() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def sig_declared(family: str, sig: Tuple) -> bool:
    """Is (family, signature) inside the declared surface?  An unknown
    family has none: every signature of it is undeclared."""
    spec = _REGISTRY.get(family)
    return spec.sig_declared(sig) if spec is not None else False


# The kernel families of the device watch's compile table: each
# wrapper's signature (gpu/devwatch.py instrumented_launch).  The
# padding that makes them true lives at the sites: StripeBatchQueue pads
# each batch's columns with covering(), and OSDMap.map_pgs walks a
# pool's whole pg vector in one launch.
declare("gf256_matmul",
        note="K1: matrix u8[R, k] (code geometry) over planes u8[k, P], "
             "P a queue batch's covering bucket or a codec's own width")
declare("gf256_interleaved",
        note="K2: matrix u8[R, k] over interleaved words i32[T, k, 128], "
             "T pow2 ladders of the engine bench")
declare("gf2_matmul",
        note="K3's popcount kernel (shec): rows u8[kin, P] into "
             "u8[rout, P], P the queue's covering bucket; w static")
declare("gf2_xor",
        note="K3's packet-XOR kernel (jerasure bit-matrix codes): rows "
             "u8[kin, P] into u8[rout, P]; w static")
declare("mesh_digest",
        note="K8's scrub digest: one stripe row u8[rows, n] of the "
             "mesh, n covering-padded to pow2 multiples of dp")
declare("kernel_build",
        note="the one build of csrc/*.cu (ops/_build.py): its "
             "signature is the source list")
# The queue kinds' batch surface (the batches the kinds above launch
# over).
declare("enc",
        note="queue kind enc: K1 over planes u8[k, P], P the covering "
             "bucket of the batch's columns; k/m are code geometry")
declare("encp",
        note="queue kind encp: K1 over u8[k, P] into the m coding rows "
             "below, then one crc32c_rows launch over the [k+m, P] batch")
declare("dec",
        note="queue kind dec: K1 with the signature's k x k recovery "
             "matrix over survivor planes u8[k, P], P covering-padded")
declare("crep",
        note="queue kind crep (clay): the codec's repair_planes over "
             "helper planes u8[d, L, s], the jobs side by side along s, "
             "s covering-padded; d, L are code geometry")
declare("cdec",
        note="queue kind cdec (clay): the codec's decode_planes over "
             "survivor chunks u8[A, Z*s], s covering-padded")
declare("gf256_clay",
        note="K1 inside clay: 1x2 pair transforms, the m x kk coding "
             "product and q x kk solves over u8[2 or kk, P*s] or "
             "[kk, L*s]; P and L are grid constants, s the queue's "
             "covering-padded per-sub-chunk width")
declare("crc32c_rows",
        note="(J, S) rows at column offsets of a u8[S, P] batch, P the "
             "queue's covering bucket; S = k+m shards")
declare("crush_rule", free_args=(1,),
        note="xs i32[n]: a pool's pg vector (map_pgs) or one id "
             "(pg_to_up_acting); arg1 is the weight vector, sized by "
             "the map epoch's OSD count (free)")
declare("meshio",
        note="stripe axis covering-padded to pow2 multiples of 4*dp "
             "(encode_scatter, recovery_gather; dp for scrub_digest): "
             "K1 a mesh cell over its column slice, mesh_digest a stripe "
             "row")


# ---------------------------------------------------------------------------
# The reference's persistent XLA compile cache
# ---------------------------------------------------------------------------

_cache_lock = make_lock("shapebucket.cache")
_cache_dir: Optional[str] = None


def setup_compile_cache(path: str) -> bool:
    """Record ``path`` (conf ``tpu_compile_cache_dir``) and return False:
    the port compiles no XLA program, so there is no compile cache to
    point at it.  Its kernels are built once per checkout into
    ``ceph_tpu_torch/_build/`` (``ops/_build.py``), and a later process
    loads that build instead of building again."""
    global _cache_dir
    with _cache_lock:
        _cache_dir = str(path) if path else None
    return False


def compile_cache_dir() -> Optional[str]:
    return _cache_dir


# ---------------------------------------------------------------------------
# Boot-time warmup
# ---------------------------------------------------------------------------

# the column widths each codec family is warmed at: the reference's
# covering buckets of the chunk widths small objects produce (4 KiB ..
# 256 KiB objects over k in 2..8), then every covering bucket up to the
# stripe-batch queue's max_batch_cols (1 Mi): a coalesced batch is never
# wider, and RADOS's default 4 MiB objects over k = 4..8 fill 512 KiB ..
# 1 MiB batches
WARM_COLS = (4096, 16384, 32768, 65536, 131072, 262144, 524288, 1048576)
# the bytes of its batch's first row the CRC item reads: the kernel's
# signature is the [k+m, width] batch, a row's length is call data, and
# the CPU's plain CRC is serial over a row's bytes
WARM_CRC_BYTES = 64


class _WarmItem:
    __slots__ = ("family", "desc", "thunk")

    def __init__(self, family: str, desc: str, thunk: Callable) -> None:
        self.family = family
        self.desc = desc
        self.thunk = thunk


class DeviceWarmup:
    """Build the kernels and launch each declared bucket once before
    anyone waits on them.

    The plan is deterministic: with ``crush``, its walks first (a
    daemon's: one ``map_pgs`` and one ``pg_to_up_acting`` a pool, K6);
    then, smallest buckets first, per width of ``cols`` one
    ``crc32c_rows`` launch reading :data:`WARM_CRC_BYTES` of the
    [k+m, width] batch; with a codec, one ``encode_planes`` product (K1,
    family ``enc``) and, for a codec with MDS recovery, one recovery
    product with the first m shards lost (K1, family ``dec``).  It runs
    under the device watch's ``warmup_scope``, so each first launch is
    classed ``warmup``.
    ``run()`` is bounded by its budget and resumable: what the budget cut
    off stays pending for the next ``run()`` (the ``device warmup`` admin
    command), and an item whose precondition is missing (no osdmap yet,
    so no codec) is retried there.  Tensors are made on ``device`` (None:
    the card, and the constructor raises without one; a codec given
    without a device names its own), or on the codec's device for the
    codec items."""

    def __init__(self, codec=None, *, cols: Tuple[int, ...] = WARM_COLS,
                 codec_fn: Optional[Callable] = None,
                 crush: Optional[Callable] = None, device=None) -> None:
        self._codec = codec
        self._codec_fn = codec_fn
        self._crush = crush
        if codec is not None and device is None:
            self._device = codec.device
        else:
            from ceph_tpu_torch.device import resolve_device

            self._device = resolve_device(device)
        self._cols = tuple(sorted(int(c) for c in cols))
        self._pending: List[_WarmItem] = self._build_plan()
        self._warmed: List[str] = []
        self._skipped: List[str] = []
        self._seconds = 0.0
        self._runs = 0
        self._lock = make_lock("shapebucket.warmup")

    def _codec_now(self):
        if self._codec is not None:
            return self._codec
        if self._codec_fn is not None:
            self._codec = self._codec_fn()
        return self._codec

    def _dev(self, codec=None):
        return codec.device if codec is not None else self._device

    # -- plan --------------------------------------------------------------
    def _build_plan(self) -> List[_WarmItem]:
        items: List[_WarmItem] = []
        # the rule walks first: a daemon walks its PGs as soon as its
        # warmup returns, budget cut or not
        if self._crush is not None:
            items.append(_WarmItem(
                "crush_rule", "crush rule programs", self._warm_crush))
        for c in self._cols:
            items.append(_WarmItem(
                "crc32c_rows", f"crc cols={c}",
                lambda c=c: self._warm_crc(c)))
        if self._codec is not None or self._codec_fn is not None:
            for c in self._cols:
                items.append(_WarmItem(
                    "enc", f"encode cols~{c}",
                    lambda c=c: self._warm_encode(c)))
            for c in self._cols:
                items.append(_WarmItem(
                    "dec", f"decode cols~{c}",
                    lambda c=c: self._warm_decode(c)))
        return items

    # -- per-family warmers (False = precondition missing, retry) ----------
    def _warm_crc(self, cols: int) -> bool:
        from ceph_tpu_torch.ops.crc32c_device import crc32c_rows

        codec = self._codec_now()
        if codec is None and self._codec_fn is not None:
            return False  # shard count unknown until the osdmap lands
        shards = (codec.k + codec.m) if codec is not None else 1
        full = torch.zeros((shards, cols), dtype=torch.uint8,
                           device=self._dev(codec))
        crc32c_rows(full, [0], [min(cols, WARM_CRC_BYTES)])
        return True

    def _warm_encode(self, cols: int) -> bool:
        codec = self._codec_now()
        if codec is None:
            return False
        w = covering(cols, codec.get_sub_chunk_count())
        if not hasattr(codec, "encode_planes"):
            # lrc encodes through encode_array (its chunk mapping)
            codec.encode_array(torch.zeros((codec.k, w),
                                           dtype=torch.uint8).numpy())
            return True
        full = torch.zeros((codec.k + codec.m, w), dtype=torch.uint8,
                           device=codec.device)
        codec.encode_planes(full[:codec.k], out=full[codec.k:])
        return True

    def _warm_decode(self, cols: int) -> bool:
        codec = self._codec_now()
        if codec is None:
            return False
        if codec.is_array:
            # array codec (clay): the queue's crep and cdec at its
            # covering width, one lost shard and the first m lost
            gran = codec.get_sub_chunk_count()
            n = codec.k + codec.m
            s = covering(cols, gran) // gran
            L = len(codec.repair_layers(0))
            codec.repair_planes(0, list(range(1, codec.d + 1)), torch.zeros(
                (codec.d, L, s), dtype=torch.uint8, device=codec.device))
            avail = list(range(codec.m, n))
            codec.decode_planes(avail, torch.zeros(
                (len(avail), gran * s), dtype=torch.uint8,
                device=codec.device))
            return True
        if not getattr(codec, "mds_recovery", False):
            return True  # no recovery product on the queue to warm
        from ceph_tpu_torch.ops import gf256

        n = codec.k + codec.m
        # one representative survivor signature: the first m shards lost
        sig = list(range(codec.m, n))[: codec.k]
        rec, _bits = codec.recovery_matrix(sig)
        x = torch.zeros((codec.k, covering(cols)), dtype=torch.uint8,
                        device=codec.device)
        # the queue's dec dispatch donates its input, so the warm does too
        gf256.gf_matmul_bytes(rec, x, donate=True)
        return True

    def _warm_crush(self) -> bool:
        return bool(self._crush())

    # -- execution ---------------------------------------------------------
    def run(self, budget_s: float = 30.0) -> Dict[str, Any]:
        """Run pending plan items until the budget is spent, under the
        device watch's ``warmup_scope``; returns :meth:`stats` and
        publishes them as the watch's ``warmup_stats``.  A negative
        budget runs everything."""
        from ceph_tpu_torch.gpu import devwatch

        w = devwatch.watch()
        t0 = time.monotonic()
        budget_s = float(budget_s)
        with self._lock:
            self._runs += 1
            self._skipped = []
            pending, self._pending = self._pending, []
            with w.warmup_scope():
                for i, item in enumerate(pending):
                    if budget_s >= 0 and \
                            time.monotonic() - t0 > budget_s:
                        self._pending.extend(pending[i:])
                        self._skipped.extend(
                            f"{it.family}: {it.desc} (budget)"
                            for it in pending[i:])
                        break
                    try:
                        ok = item.thunk()
                    except Exception as e:
                        self._skipped.append(
                            f"{item.family}: {item.desc} (error: {e!r})")
                        continue
                    if ok:
                        self._warmed.append(f"{item.family}: {item.desc}")
                    else:
                        self._pending.append(item)
                        self._skipped.append(
                            f"{item.family}: {item.desc} (not ready)")
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
            self._seconds += time.monotonic() - t0
            st = self._stats_locked()
        w.warmup_stats = st
        return st

    def pending(self) -> int:
        """Plan items not yet warmed."""
        with self._lock:
            return len(self._pending)

    def _stats_locked(self) -> Dict[str, Any]:
        fams = sorted({i.split(":")[0] for i in self._warmed})
        return {
            "runs": self._runs,
            "seconds": round(self._seconds, 3),
            "families_warmed": fams,
            "buckets_warmed": len(self._warmed),
            "warmed": list(self._warmed),
            "pending": len(self._pending),
            "skipped": list(self._skipped),
            "done": not self._pending,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return self._stats_locked()
