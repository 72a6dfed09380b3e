"""Clay (coupled-layer) MSR codes: sub-chunk array codes with optimal
single-node repair bandwidth.

Port of ``ceph_tpu/ec/clay.py``: the same construction, bit for bit.

Construction (k data + m coding, d = k+m-1 helpers):

- q = d-k+1 (= m), t = (k+nu+m)/q with nu virtual all-zero data chunks
  padding k+m to a multiple of q.  Node i sits at (x=i%q, y=i//q) of a
  q x t grid; each chunk holds q^t sub-chunks indexed by the base-q
  digits z = (z_0..z_{t-1}) (y=0 most significant).
- The uncoupled symbols U form one MDS codeword per layer z; the stored
  symbols C couple column pairs: for (x,y,z) with z_y != x the partner
  is node (z_y, y) at layer z(y->x), through (char-2 GF(2^8), gamma not
  in {0,1})::

      C1 = U1 + g*U2          U1 = (C1 + g*C2) / (1+g^2)
      C2 = g*U1 + U2          U2 = (g*C1 + C2) / (1+g^2)

  Symbols with z_y == x (the "dots") are uncoupled: C = U.
- A single lost node (x0,y0) is rebuilt from the q^(t-1) layers with
  z_y0 = x0 of each of the d survivors: d/(k*q) of the bytes an RS
  repair reads (11/32 for k=8 m=4 d=11).

On the device every GF(2^8) product goes through ``ops.gf256``'s
``gf_matmul_bytes`` (K1 on a CUDA tensor, its plain version on a CPU
tensor): the 1x2 pair transforms, the per-layer MDS product of the
encode and the cached q x kk solves.  The gathers and scatters around
them are ``index_select``/``index_copy_`` over index tensors that live
on the codec's device, built once per codec (encode), per lost shard
and helper set (repair) and per survivor set (decode), and cached as
the solve matrices are.  Symbols are rows of [nodes * layers, s]
tensors, s the bytes of one sub-chunk, so every step is elementwise
over s: the stripe-batch queue lays many objects side by side along s
and runs them as one repair, decode or encode.  A host call
(``encode_array``, ``decode_array``, ``repair_chunk``) uploads its
planes once and downloads its result once.

The reference computes each pair transform over the whole volume and
selects with ``np.where``; the port computes it only at the positions
the select keeps, and a solve only over the kk rows its matrix reads.
The bytes are the same.

``mds_recovery`` is False (nothing sends clay down the queue's flat
``dec`` kind) and ``supports_partial_writes()`` False.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import gf, matrices
from ceph_tpu_torch.ec.interface import (
    SIMD_ALIGN,
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
    to_int,
)
from ceph_tpu_torch.ops import gf256

_CACHE_MAX = 256


def _gf_pair(a: int, b: int) -> np.ndarray:
    return np.array([[a, b]], dtype=np.uint8)


def _cached(cache: dict, key, build):
    """cache[key], built on a miss; the cache is emptied when full, as
    the K1 operand cache is."""
    got = cache.get(key)
    if got is None:
        if len(cache) >= _CACHE_MAX:
            cache.clear()
        got = cache[key] = build()
    return got


class ClayCodec(ErasureCode):
    """Coupled-layer MSR codec, its products on ``device``."""

    # recovery is not one k x k matrix product: the queue's dec kind
    # never takes clay (its decodes ride cdec, its repairs crep)
    mds_recovery = False

    def __init__(self, k: int = 0, m: int = 0, d: int | None = None,
                 gamma: int = 2, device=None):
        super().__init__()
        self._k = int(k)
        self._m = int(m)
        self._d = int(d) if d is not None else 0
        self.gamma = int(gamma)
        self.device = resolve_device(device)
        # GF(2^8) products launched; of them the 1x2 pair transforms
        # (K1 runs each at its 4x4 bucket) and those whose width was not
        # a whole number of 4-byte words (K1's padded copy)
        self.products = 0
        self.pair_products = 0
        self.ragged_products = 0
        if k and m:
            self._setup()

    # -- profile plumbing (plugin registry path) ---------------------------
    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self._k = to_int(profile, "k", 4)
        self._m = to_int(profile, "m", 2)
        self._d = to_int(profile, "d", self._k + self._m - 1)
        self._setup()

    def _setup(self) -> None:
        k, m = self._k, self._m
        if not self._d:
            self._d = k + m - 1
        d = self._d
        if d != k + m - 1:
            raise ErasureCodeError(
                f"clay: only d = k+m-1 supported (got d={d}, k={k}, m={m})")
        if k < 2:
            raise ErasureCodeError("k must be >= 2")
        if m < 2:
            raise ErasureCodeError("clay needs m >= 2")
        if self.gamma in (0, 1):
            raise ErasureCodeError("clay: gamma must not be 0 or 1")
        self.q = d - k + 1  # == m
        self.nu = (self.q - (k + m) % self.q) % self.q
        self.t = (k + m + self.nu) // self.q
        self.sub_count = self.q ** self.t
        kk = k + self.nu  # internal data width incl. virtual zero chunks
        self.kk = kk
        assert kk == self.q * (self.t - 1), "parity column must be whole"
        # the MDS code applied per uncoupled layer
        self.coding = matrices.isa_cauchy(kk, m)
        self.coding_u8 = np.ascontiguousarray(self.coding, dtype=np.uint8)
        self.full_generator = matrices.full_generator(self.coding)
        g = self.gamma
        det = 1 ^ int(gf.mul(g, g))  # 1 + g^2 (char 2)
        inv_det = int(gf.inv(det))
        inv_g = int(gf.inv(g))
        self._det = det
        # [[a, b]] row transforms (see the module docstring):
        #   uncouple: U1 = inv_det*C1 + inv_det*g*C2
        #   couple:   C1 = U1 + g*U2
        #   repair:   C(A) = (det*U(B) + C(B)) / g
        #   C from own U and a known partner C: C1 = det*U1 + g*C2
        self._uncouple_M = _gf_pair(inv_det, int(gf.mul(inv_det, g)))
        self._couple_M = _gf_pair(1, g)
        self._repair_M = _gf_pair(int(gf.mul(det, inv_g)), inv_g)
        self._c_from_U_M = _gf_pair(det, g)
        self._pair_tables()
        self._solve_cache: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]],
                                np.ndarray] = {}
        self._repair_plans: Dict[tuple, dict] = {}
        self._decode_plans: Dict[tuple, dict] = {}
        self._encode_plan = None

    def _pair_tables(self) -> None:
        """Per-(node, layer) partner indices and dot masks (host, numpy:
        the bookkeeping every device plan is built from)."""
        q, t = self.q, self.t
        n = self.kk + self._m
        zs = np.arange(self.sub_count)
        # digit y of layer z (y=0 most significant)
        self.digits = np.stack(
            [(zs // q ** (t - 1 - y)) % q for y in range(t)])  # [t, Z]
        x = np.arange(n) % q
        y = np.arange(n) // q
        dig_y = self.digits[y]  # [n, Z]: z_y per node
        self.dot = dig_y == x[:, None]  # [n, Z]
        self.pnode = y[:, None] * q + dig_y  # partner node (z_y, y)
        # partner layer: digit y replaced by x
        pw = np.array([q ** (t - 1 - yy) for yy in range(t)])
        self.pz = zs[None, :] + (x[:, None] - dig_y) * pw[y][:, None]

    # -- shape queries ----------------------------------------------------
    @property
    def k(self) -> int:
        return self._k

    @property
    def m(self) -> int:
        return self._m

    @property
    def d(self) -> int:
        return self._d

    def get_sub_chunk_count(self) -> int:
        return self.sub_count

    def get_alignment(self) -> int:
        # chunk_size must split into q^t sub-chunks and stay SIMD-aligned
        return SIMD_ALIGN * self.sub_count // math.gcd(
            SIMD_ALIGN, self.sub_count)

    def supports_partial_writes(self) -> bool:
        """False: a byte at sub-chunk z of a data chunk feeds, through
        the coupling, the uncoupled symbol at the partner layer of
        another node, so only whole chunks close under a write (the
        reference likewise refuses ec_overwrites on clay pools)."""
        return False

    # -- device helpers -----------------------------------------------------
    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=self.device)

    def _mul(self, M: np.ndarray, x: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
        """One GF(2^8) product on K1 (its plain version on the CPU)."""
        self.products += 1
        if x.shape[1] % 4:
            self.ragged_products += 1
        return gf256.gf_matmul_bytes(M, x, out=out)

    def _pair(self, M: np.ndarray, a: torch.Tensor, ia: torch.Tensor,
              b: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
        """Rows a[ia] and b[ib] of [*, s] symbol tensors gathered side
        by side into one [2, P*s] batch, then one 1x2 product:
        M[0,0]*a + M[0,1]*b, returned as [P, s]."""
        P, s = int(ia.numel()), a.shape[1]
        buf = torch.empty((2, P, s), dtype=torch.uint8, device=a.device)
        torch.index_select(a, 0, ia, out=buf[0])
        torch.index_select(b, 0, ib, out=buf[1])
        self.pair_products += 1
        return self._mul(M, buf.view(2, P * s)).reshape(P, s)

    def _to_dev(self, planes) -> torch.Tensor:
        if isinstance(planes, torch.Tensor):
            if planes.device != self.device:
                raise ValueError(f"clay: planes on {planes.device}, codec "
                                 f"on {self.device}")
            return planes
        x = torch.from_numpy(np.ascontiguousarray(planes, dtype=np.uint8))
        return x.to(self.device)

    # -- encode ------------------------------------------------------------
    def _build_encode_plan(self) -> dict:
        """Rows of the data grid [kk*Z, s] that couple (not dot) and
        their partners', and the same over the parity column."""
        Z = self.sub_count
        dn = np.arange(self.kk)
        nd_d = ~self.dot[dn]
        rows_d = (dn[:, None] * Z + np.arange(Z)[None, :])[nd_d]
        part_d = (self.pnode[dn] * Z + self.pz[dn])[nd_d]
        pn = np.arange(self.kk, self.kk + self._m)
        nd_p = ~self.dot[pn]
        rows_p = ((pn - self.kk)[:, None] * Z + np.arange(Z)[None, :])[nd_p]
        part_p = ((self.pnode[pn] - self.kk) * Z + self.pz[pn])[nd_p]
        return {"rows_d": self._idx(rows_d), "part_d": self._idx(part_d),
                "rows_p": self._idx(rows_p), "part_p": self._idx(part_p)}

    def encode_planes(self, planes: torch.Tensor,
                      out: torch.Tensor | None = None,
                      jobs=None) -> torch.Tensor:
        """uint8 [k, n] data planes on the codec's device (n a multiple
        of the sub-chunk count) -> [m, n] coding, into ``out`` when
        given.  Columns are layer-major (sub-chunk z is columns
        [z*s, (z+1)*s)), so the planes must be ONE codeword's chunks:
        jobs laid side by side along the raw columns would let the
        layer axis take a neighbour's bytes.  The queue lays clay jobs
        along the sub-chunk byte axis instead and calls this once over
        the batch; ``jobs`` is accepted only when it is that one job."""
        if jobs is not None and len(jobs[1]) != 1:
            raise ErasureCodeError(
                "clay encode_planes codes one codeword; lay jobs along "
                "the sub-chunk byte axis (StripeBatchQueue does)")
        k, n = planes.shape
        Z = self.sub_count
        if k != self._k or n % Z:
            raise ErasureCodeError(
                f"clay encode: bad planes {tuple(planes.shape)} "
                f"(k={self._k}, n must be a multiple of {Z})")
        s = n // Z
        if self._encode_plan is None:
            self._encode_plan = self._build_encode_plan()
        plan = self._encode_plan
        dev = planes.device
        if self.nu:
            C = torch.zeros((self.kk * Z, s), dtype=torch.uint8, device=dev)
            C[: k * Z] = planes.reshape(k * Z, s)
        else:
            C = planes.reshape(k * Z, s)
        # uncouple the data grid, then one MDS product over every layer
        U = C.clone()
        if plan["rows_d"].numel():
            U.index_copy_(0, plan["rows_d"], self._pair(
                self._uncouple_M, C, plan["rows_d"], C, plan["part_d"]))
        if out is None:
            out = torch.empty((self._m, n), dtype=torch.uint8, device=dev)
        U_par = self._mul(self.coding_u8, U.view(self.kk, Z * s), out=out)
        # couple the parity column back to stored symbols, in place
        flat = U_par.view(self._m * Z, s)
        if plan["rows_p"].numel():
            flat.index_copy_(0, plan["rows_p"], self._pair(
                self._couple_M, flat, plan["rows_p"], flat,
                plan["part_p"]))
        return U_par

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        k, n = data.shape
        if k != self._k or n % self.sub_count:
            raise ErasureCodeError(
                f"clay encode: bad planes {data.shape} (k={self._k}, "
                f"n must be a multiple of {self.sub_count})")
        return self.encode_planes(self._to_dev(data)).cpu().numpy()

    # -- repair (single erasure, the MSR bandwidth win) --------------------
    def _node(self, ext: int) -> int:
        """External chunk id -> internal grid node id (virtual zero
        chunks occupy internal slots [k, k+nu))."""
        return ext if ext < self._k else ext + self.nu

    def repair_layers(self, lost: int) -> np.ndarray:
        """The q^(t-1) layer indices z with z_y0 == x0 (lost is an
        external chunk id)."""
        n = self._node(lost)
        x0, y0 = n % self.q, n // self.q
        return np.nonzero(self.digits[y0] == x0)[0]

    def minimum_to_decode(
        self, want_to_read: Iterable[int], available: Iterable[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Sub-chunk-aware helper selection: a single lost chunk reads
        only the repair layers of every survivor (reference semantics:
        ErasureCodeInterface.h:297-325)."""
        want = sorted(set(want_to_read))
        avail = sorted(set(available))
        missing = [w for w in want if w not in avail]
        if len(missing) == 1 and len(avail) >= self.d:
            runs = _as_runs(self.repair_layers(missing[0]))
            helpers = [a for a in avail if a != missing[0]][: self.d]
            return {h: runs for h in helpers}
        return super().minimum_to_decode(want_to_read, available)

    def repair_read_bytes(self, lost: Sequence[int], helpers: Iterable[int],
                          chunk_size: int | None = None) -> int:
        """Total bytes read for a repair plan (for assertions/bench)."""
        plan = self.minimum_to_decode(lost, helpers)
        cs = chunk_size if chunk_size is not None else self.sub_count
        s = cs // self.sub_count
        return sum(sum(c for _, c in runs) * s for runs in plan.values())

    def repair_chunk(
        self, lost: Sequence[int], chunks: Mapping[int, np.ndarray],
        *, layers_only: bool = False,
    ) -> Dict[int, np.ndarray]:
        """Recover ONE lost chunk reading only repair-layer sub-chunks.

        ``chunks`` values are full chunks (sliced here), or, with
        ``layers_only=True``, just the repair-layer sub-chunks
        concatenated in layer order."""
        (l0,) = lost
        Z = self.sub_count
        layers = self.repair_layers(l0)
        L = len(layers)
        helpers = sorted(h for h in chunks.keys() if h != l0)
        if len(helpers) < self.d:
            raise ErasureCodeError(
                f"clay repair needs d={self.d} helpers, have {len(helpers)}")
        helpers = helpers[: self.d]
        sizes = {np.asarray(chunks[h]).size for h in helpers}
        if len(sizes) != 1:
            raise ErasureCodeError("clay repair: helper sizes differ")
        size = sizes.pop()
        s = size // Z if not layers_only else size // L
        planes = np.empty((self.d, L, s), dtype=np.uint8)
        for hi, h in enumerate(helpers):
            arr = np.asarray(chunks[h], dtype=np.uint8).ravel()
            planes[hi] = (arr.reshape(L, s) if layers_only
                          else arr.reshape(Z, s)[layers])
        out = self._repair_dev(l0, helpers, self._to_dev(planes))
        return {l0: out.cpu().numpy().reshape(-1)}

    def _build_repair_plan(self, lost: int, helpers: Tuple[int, ...]
                           ) -> dict:
        q, Z = self.q, self.sub_count
        l0n = self._node(lost)
        x0, y0 = l0n % q, l0n // q
        layers = self.repair_layers(lost)
        L = len(layers)
        n_total = self.kk + self._m
        lpos = np.full(Z, -1)
        lpos[layers] = np.arange(L)
        # 1. the U of every node outside column y0 (exactly kk nodes,
        #    the solve's basis): partners stay in the repair layers
        nodes_other = np.array([i for i in range(n_total) if i // q != y0])
        Lr = np.arange(L)
        own = nodes_other[:, None] * L + Lr[None, :]            # Cr rows
        part = (self.pnode[nodes_other][:, layers] * L
                + lpos[self.pz[nodes_other][:, layers]])
        nd = ~self.dot[nodes_other][:, layers]
        # 2. the solve: q column-y0 unknowns from the kk known U rows
        col = list(range(y0 * q, y0 * q + q))
        M = self._solve_matrix(col, nodes_other.tolist())
        # 3b. the lost node's other layers from each column-y0 partner
        pw_y0 = q ** (self.t - 1 - y0)
        zs_cat, ub, cb = [], [], []
        for xb in range(q):
            if xb == x0:
                continue
            zs_a = np.nonzero(self.digits[y0] == xb)[0]
            zb = lpos[zs_a + (x0 - xb) * pw_y0]
            assert (zb >= 0).all()
            zs_cat.append(zs_a)
            ub.append(xb * L + zb)                          # U_col rows
            cb.append((y0 * q + xb) * L + zb)               # Cr rows
        return {
            "L": L, "x0": x0, "M": M,
            "h_nodes": self._idx([self._node(h) for h in helpers]),
            "own": self._idx(own.ravel()),
            "nd_pos": self._idx(np.nonzero(nd.ravel())[0]),
            "nd_own": self._idx(own[nd]),
            "nd_part": self._idx(part[nd]),
            "layers": self._idx(layers),
            "zs_cat": self._idx(np.concatenate(zs_cat)),
            "ub": self._idx(np.concatenate(ub)),
            "cb": self._idx(np.concatenate(cb)),
        }

    def _repair_plan(self, lost: int, helpers: Sequence[int]) -> dict:
        key = (int(lost), tuple(int(h) for h in helpers))
        return _cached(self._repair_plans, key,
                       lambda: self._build_repair_plan(*key))

    def _repair_dev(self, lost: int, helpers: Sequence[int],
                    planes: torch.Tensor) -> torch.Tensor:
        """planes [d, L, s] on the device -> the rebuilt chunk [Z, s]."""
        plan = self._repair_plan(lost, helpers)
        L = plan["L"]
        if planes.dim() != 3 or tuple(planes.shape[:2]) != (len(helpers),
                                                             L):
            raise ErasureCodeError(
                f"clay repair_planes: bad planes {tuple(planes.shape)} "
                f"(want ({len(helpers)}, {L}, S))")
        s = planes.shape[2]
        n_total = self.kk + self._m
        dev = planes.device
        # read planes by INTERNAL node id; virtual nodes stay zero
        Cr = torch.zeros((n_total, L * s), dtype=torch.uint8, device=dev)
        Cr.index_copy_(0, plan["h_nodes"], planes.reshape(len(helpers),
                                                          L * s))
        Cr = Cr.view(n_total * L, s)
        U_known = torch.index_select(Cr, 0, plan["own"])
        if plan["nd_pos"].numel():
            U_known.index_copy_(0, plan["nd_pos"], self._pair(
                self._uncouple_M, Cr, plan["nd_own"], Cr, plan["nd_part"]))
        U_col = self._mul(plan["M"], U_known.view(self.kk, L * s)).reshape(
            self.q * L, s)
        out = torch.empty((self.sub_count, s), dtype=torch.uint8,
                          device=dev)
        x0 = plan["x0"]
        out.index_copy_(0, plan["layers"], U_col[x0 * L:(x0 + 1) * L])
        out.index_copy_(0, plan["zs_cat"], self._pair(
            self._repair_M, U_col, plan["ub"], Cr, plan["cb"]))
        return out

    def repair_planes(self, lost: int, helpers: Sequence[int], planes):
        """Batched single-erasure repair: ``planes`` [d, L, S] holds each
        helper's repair-layer sub-chunks (row order = ``helpers``, layer
        order = ``repair_layers(lost)``); returns the rebuilt chunk as
        [Z, S].  A tensor on the codec's device gives a tensor there;
        numpy gives numpy (one upload, one download).

        Every step is elementwise over the S axis, so the queue's crep
        kind lays many objects' repairs along S and runs them as one."""
        if isinstance(planes, torch.Tensor):
            return self._repair_dev(lost, helpers, self._to_dev(planes))
        planes = np.asarray(planes, dtype=np.uint8)
        return self._repair_dev(lost, helpers,
                                self._to_dev(planes)).cpu().numpy()

    def _solve_matrix(self, unknown: List[int], known: List[int]
                      ) -> np.ndarray:
        """The [len(unknown) x kk] matrix giving the U rows of `unknown`
        node ids from the first kk `known` U rows, cached per signature
        (the ErasureCodeIsaTableCache role, reference: src/erasure-code/
        isa/ErasureCodeIsa.cc:226-302)."""
        key = (tuple(unknown), tuple(known))
        M = self._solve_cache.get(key)
        if M is None:
            R = matrices.decode_matrix(self.full_generator, known[: self.kk])
            M = np.ascontiguousarray(
                gf.matmul(self.full_generator[np.asarray(unknown)], R),
                dtype=np.uint8)
            self._solve_cache[key] = M
        return M

    # -- general decode (multi-erasure, layered IS ordering) ---------------
    def _build_decode_plan(self, avail: Tuple[int, ...]) -> dict:
        """Index tensors of the intersection-score decode for one
        survivor set: per IS level the known-basis rows by case (dot,
        partner known, partner erased) and the solve, then the erased
        nodes' stored symbols by case."""
        Z = self.sub_count
        n_total = self.kk + self._m
        known_mask = np.zeros(n_total, dtype=bool)
        src = {}
        for i in range(n_total):
            ext = i if i < self._k else (i - self.nu if i >= self.kk
                                         else None)
            if ext is not None and ext in avail:
                known_mask[i] = True
                src[i] = avail.index(ext)
            elif self._k <= i < self.kk:  # virtual zero chunk
                known_mask[i] = True
        erased_n = [i for i in range(n_total) if not known_mask[i]]
        known_n = [i for i in range(n_total) if known_mask[i]]
        basis = np.asarray(known_n[: self.kk])
        M = self._solve_matrix(erased_n, known_n)
        real = sorted(src)
        # intersection score per layer = number of erased dot coords
        IS = np.zeros(Z, dtype=np.int64)
        for e in erased_n:
            IS += self.dot[e].astype(np.int64)
        er = np.asarray(erased_n)
        levels = []
        have = np.zeros((n_total, Z), dtype=bool)
        for level in range(int(IS.max()) + 1):
            zs = np.nonzero(IS == level)[0]
            if len(zs) == 0:
                continue
            rows = basis[:, None] * Z + zs[None, :]
            pn = self.pnode[basis][:, zs]
            prow = pn * Z + self.pz[basis][:, zs]
            dot = self.dot[basis][:, zs]
            pk = known_mask[pn]
            pe = ~dot & ~pk
            assert have.reshape(-1)[prow[pe]].all(), "IS ordering violated"
            levels.append({
                "dot": self._idx(rows[dot]),
                "pk": self._idx(rows[~dot & pk]),
                "pk_part": self._idx(prow[~dot & pk]),
                "pe": self._idx(rows[pe]),
                "pe_part": self._idx(prow[pe]),
                "basis": self._idx(rows.ravel()),
                "erased": self._idx((er[:, None] * Z + zs[None, :]).ravel()),
                "nz": len(zs),
            })
            have[basis[:, None], zs[None, :]] = True
            have[er[:, None], zs[None, :]] = True
        # the erased nodes' stored symbols, every layer at once
        rows = er[:, None] * Z + np.arange(Z)[None, :]
        pn = self.pnode[er]
        prow = pn * Z + self.pz[er]
        dot = self.dot[er]
        pk = known_mask[pn]
        return {
            "real": self._idx(real),
            "real_src": self._idx([src[i] for i in real]),
            "M": M, "levels": levels, "e": len(erased_n),
            "fin_dot": self._idx(rows[dot]),
            "fin_pk": self._idx(rows[~dot & pk]),
            "fin_pk_part": self._idx(prow[~dot & pk]),
            "fin_pe": self._idx(rows[~dot & ~pk]),
            "fin_pe_part": self._idx(prow[~dot & ~pk]),
        }

    def _decode_dev(self, avail: Tuple[int, ...], X: torch.Tensor
                    ) -> torch.Tensor:
        """Survivor chunks X [A, n] (rows in ``avail`` order) -> the
        stored symbols of every internal node, [(kk+m)*Z, s]."""
        Z = self.sub_count
        n = X.shape[1]
        s = n // Z
        n_total = self.kk + self._m
        plan = _cached(self._decode_plans, avail,
                       lambda: self._build_decode_plan(avail))
        dev = X.device
        C = torch.zeros((n_total, n), dtype=torch.uint8, device=dev)
        C.index_copy_(0, plan["real"],
                      torch.index_select(X, 0, plan["real_src"]))
        C = C.view(n_total * Z, s)
        U = torch.zeros_like(C)
        for lv in plan["levels"]:
            if lv["dot"].numel():
                U.index_copy_(0, lv["dot"],
                              torch.index_select(C, 0, lv["dot"]))
            if lv["pk"].numel():
                U.index_copy_(0, lv["pk"], self._pair(
                    self._uncouple_M, C, lv["pk"], C, lv["pk_part"]))
            if lv["pe"].numel():
                U.index_copy_(0, lv["pe"], self._pair(
                    self._couple_M, C, lv["pe"], U, lv["pe_part"]))
            known = torch.index_select(U, 0, lv["basis"]).view(
                self.kk, lv["nz"] * s)
            solved = self._mul(plan["M"], known)
            U.index_copy_(0, lv["erased"],
                          solved.reshape(plan["e"] * lv["nz"], s))
        if plan["fin_dot"].numel():
            C.index_copy_(0, plan["fin_dot"],
                          torch.index_select(U, 0, plan["fin_dot"]))
        if plan["fin_pk"].numel():
            C.index_copy_(0, plan["fin_pk"], self._pair(
                self._c_from_U_M, U, plan["fin_pk"], C,
                plan["fin_pk_part"]))
        if plan["fin_pe"].numel():
            C.index_copy_(0, plan["fin_pe"], self._pair(
                self._couple_M, U, plan["fin_pe"], U, plan["fin_pe_part"]))
        return C

    def _rebuild_dev(self, avail: Sequence[int], X: torch.Tensor,
                     targets: Sequence[int]) -> torch.Tensor:
        """Chunks ``targets`` (external ids, none of them in ``avail``)
        from the survivors X [A, n] -> [len(targets), n]: the single-
        erasure repair from d helpers' repair layers when exactly one
        chunk is lost and d survive, else the general decode."""
        avail = tuple(int(a) for a in avail)
        Z = self.sub_count
        n = X.shape[1]
        erased = sorted(set(range(self._k + self._m)) - set(avail))
        if len(erased) > self._m:
            raise ErasureCodeError("too many erasures for clay")
        if n % Z:
            raise ErasureCodeError(
                f"clay decode: chunk width {n} is not a multiple of {Z}")
        s = n // Z
        if len(erased) == 1 and len(avail) >= self.d:
            l0 = erased[0]
            helpers = sorted(a for a in avail if a != l0)[: self.d]
            rows = self._idx([avail.index(h) for h in helpers])
            planes = torch.index_select(
                torch.index_select(X, 0, rows).view(len(helpers), Z, s),
                1, self._repair_plan(l0, helpers)["layers"])
            return self._repair_dev(l0, helpers, planes).view(1, n)
        C = self._decode_dev(avail, X).view(self.kk + self._m, n)
        return torch.index_select(C, 0, self._idx(
            [self._node(w) for w in targets]))

    def decode_array(
        self, available: Mapping[int, np.ndarray], want: Sequence[int],
        n: int
    ) -> Dict[int, np.ndarray]:
        avail = sorted(available.keys())
        erased = sorted(set(range(self._k + self._m)) - set(avail))
        if len(erased) > self._m:
            raise ErasureCodeError("too many erasures for clay")
        want_missing = [w for w in want if w not in avail]
        if not want_missing:
            return {w: np.asarray(available[w]) for w in want}
        X = self._to_dev(np.stack(
            [np.asarray(available[a], dtype=np.uint8).reshape(-1)[:n]
             for a in avail]))
        targets = erased if (len(erased) == 1
                             and len(avail) >= self.d) else want_missing
        got = self._rebuild_dev(avail, X, targets).cpu().numpy()
        rebuilt = dict(zip(targets, got))
        return {w: (np.asarray(available[w]) if w in available
                    else rebuilt[w]) for w in want}

    def decode_planes(self, avail_ids: Sequence[int], planes):
        """Batched data decode for the queue's cdec kind: ``planes``
        [A, n] stacks the surviving chunks (row order = ``avail_ids``, n
        a multiple of the sub-chunk count); returns the k data chunks
        [k, n].  Like repair_planes, every step is elementwise over the
        intra-sub-chunk byte axis, so objects laid side by side along
        it decode in one pass.  A tensor on the codec's device gives a
        tensor there; numpy gives numpy."""
        host = not isinstance(planes, torch.Tensor)
        X = self._to_dev(planes)
        avail = [int(a) for a in avail_ids]
        missing = [i for i in range(self._k) if i not in avail]
        out = torch.empty((self._k, X.shape[1]), dtype=torch.uint8,
                          device=X.device)
        have = [i for i in range(self._k) if i in avail]
        if have:
            out.index_copy_(0, self._idx(have), torch.index_select(
                X, 0, self._idx([avail.index(i) for i in have])))
        if missing:
            out.index_copy_(0, self._idx(missing),
                            self._rebuild_dev(avail, X, missing))
        return out.cpu().numpy() if host else out


class ErasureCodeClay:
    """Registry factory (plugin name "clay")."""

    @staticmethod
    def create(profile: dict, device=None) -> ClayCodec:
        codec = ClayCodec(device=device)
        codec.init(profile)
        return codec


def _as_runs(idx: np.ndarray) -> List[Tuple[int, int]]:
    """Sorted indices -> [(sub_chunk_offset, count)] runs."""
    runs: List[Tuple[int, int]] = []
    for i in np.sort(np.asarray(idx)):
        i = int(i)
        if runs and runs[-1][0] + runs[-1][1] == i:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((i, 1))
    return runs
