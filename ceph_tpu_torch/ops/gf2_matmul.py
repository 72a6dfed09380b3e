"""GF(2) bit-matrix product over byte rows — the bit-matrix codes' engine.

Port of ``ceph_tpu/ops/gf2_matmul.py`` and the Pallas kernel it reaches,
``_gf2_kernel`` (``:87``).  An int8 0/1 matrix ``mbits`` [8R, 8K] applied
to uint8 rows x [K, n]: expand x to bit-planes [8K, n] (plane 8j+b is
bit b of row j), multiply accumulating in int32, keep the low bit, pack
each 8 planes back into a byte: uint8 [R, n].  Every jerasure bit-matrix
technique and the shec decode run on it.

Two hand-written kernels in ``csrc/gf2_matmul.cu`` compute it, and the
operand's structure alone picks one (:class:`BitOperand`):

- the packet-XOR kernel (count ``gf2_xor``) for 0/1 packet matrices,
  whose every 8x8 block is zero or the identity: every jerasure
  bit-matrix encode and decode.  The product is then a XOR of whole
  packet rows; its plain version is :func:`gf2_xor_packets_plain`;
- the popcount kernel (count ``gf2_matmul``) for every other operand:
  shec's decode.  It runs on the binary tensor cores (``mma.sync``
  ``.b1 .and.popc``), its mask words laid out as the mma's B fragments
  (:func:`mma_fragments`).  Its plain version is
  :func:`gf2_matmul_bytes_plain`, the expand / matmul / mod 2 / pack
  written as PyTorch ops.

:func:`gf2_matmul_packets_plain` stays the definition both are held
against.  On a CPU tensor the plain version of the chosen kernel runs;
any other device than CUDA or CPU raises, and a kernel that fails to
build or launch raises: there is no fallback.  Both kernels take any
width n, not only multiples of the Pallas tile.

:func:`gf2_matmul_packets` is the batched entry of the stripe-batch
queue: jobs laid side by side in one [rows, P] buffer, each chunk row of
a job split into ``w`` packets of width/w bytes, as
``BitmatrixCodec.encode_array`` splits a job on its own.  One launch
covers up to :data:`MAX_JOBS` jobs.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.gpu.devwatch import instrumented_launch, signature
from ceph_tpu_torch.ops import _build

launches = _build.LaunchCount("gf2_matmul")     # the popcount kernel
xor_launches = _build.LaunchCount("gf2_xor")    # the packet-XOR kernel

KW_BUCKETS = (8, 16, 32)  # u32 mask words per matrix row: 1, 2, 4 mma steps
MAX_K = 4 * KW_BUCKETS[-1]   # input rows the popcount kernel takes
MAX_XOR_K = 256              # input rows the XOR kernel takes (u8 index)
MAX_JOBS = 240               # jobs per launch (csrc kMaxJobs)
MAX_SMEM = 232448            # an H100 block's shared memory (csrc kMaxSmem)
DEFAULT_SMEM = 49152         # without the opt-in (csrc kDefaultSmem)
XOR_TILE = 256               # columns a XOR-kernel tile (csrc kXorTile)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def bytes_to_bitplanes(x: torch.Tensor) -> torch.Tensor:
    """uint8 [k, n] -> int8 bit-planes [8k, n]; row 8j+b = bit b of row
    j."""
    k, n = x.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(k * 8, n).to(torch.int8)


def bitplanes_to_bytes(planes: torch.Tensor) -> torch.Tensor:
    """Integer bit-planes [8m, n] (values 0/1) -> uint8 [m, n]."""
    m8, n = planes.shape
    grouped = planes.reshape(m8 // 8, 8, n).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=planes.device))[None, :, None]
    return (grouped * weights).sum(dim=1).to(torch.uint8)


def gf2_matmul_bytes_plain(mbits, x: torch.Tensor) -> torch.Tensor:
    """Expand, multiply, mod 2, pack, on x's device.  The product runs in
    float32: every partial sum is an integer below 2^24, so it is exact
    (and CUDA has no integer matmul)."""
    mb = operand(mbits).mbits
    _check_rows(x, mb.shape[1] // 8, "x")
    m = torch.from_numpy(mb).to(device=x.device, dtype=torch.float32)
    planes = bytes_to_bitplanes(x).to(torch.float32)
    acc = torch.matmul(m, planes).to(torch.int32)
    return bitplanes_to_bytes(acc & 1)


def gf2_matmul_packets_plain(mbits, x: torch.Tensor, out: torch.Tensor,
                             offs: Sequence[int], widths: Sequence[int],
                             w: int) -> torch.Tensor:
    """The batched packet product job by job: job j's columns
    ``x[:, off:off+width]`` as w packet rows per chunk row, through
    :func:`gf2_matmul_bytes_plain`, written back to the same columns of
    ``out``."""
    kin, rout = x.shape[0], out.shape[0]
    for o, wd in zip(offs, widths):
        o, wd = int(o), int(wd)
        packets = x[:, o:o + wd].reshape(kin * w, wd // w)
        res = gf2_matmul_bytes_plain(mbits, packets)
        out[:, o:o + wd] = res.reshape(rout, wd)
    return out


def _xor_rows(t: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of t [r, n] (r >= 1), by halving."""
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])])
        t = t[0::2] ^ t[1::2]
    return t[0]


def gf2_xor_packets_plain(mbits, x: torch.Tensor, out: torch.Tensor,
                          offs: Sequence[int], widths: Sequence[int],
                          w: int) -> torch.Tensor:
    """The batched packet product of a 0/1 packet operand as packet XORs
    (the XOR kernel's function): per job, the packet rows that each
    output row's CSR list names are gathered with one index-select and
    XOR-reduced.  Equal to :func:`gf2_matmul_packets_plain` on every
    operand whose ``packet`` is set."""
    op = operand(mbits)
    if op.packet is None:
        raise ValueError("the XOR path takes only 0/1 packet operands "
                         "(each 8x8 block zero or the identity)")
    kin, rout = x.shape[0], out.shape[0]
    idx = torch.from_numpy(op.idx.astype(np.int64)).to(x.device)
    rp = op.rowptr
    for o, wd in zip(offs, widths):
        o, wd = int(o), int(wd)
        ps = wd // w
        sel = x[:, o:o + wd].reshape(kin * w, ps).index_select(0, idx)
        res = torch.zeros((op.R, ps), dtype=torch.uint8, device=x.device)
        for i in range(op.R):
            if rp[i + 1] > rp[i]:
                res[i] = _xor_rows(sel[rp[i]:rp[i + 1]])
        out[:, o:o + wd] = res.reshape(rout, wd)
    return out


def packet_matrix(mbits) -> Optional[np.ndarray]:
    """The [R, K] 0/1 packet matrix of a bit-matrix [8R, 8K] whose every
    8x8 block (taken mod 2, as the product takes it) is zero or the
    identity, else None.  Every operand a jerasure bit-matrix codec builds
    has this form; shec's GF(2^8) operands do not."""
    mb = np.asarray(mbits)
    R, K = mb.shape[0] // 8, mb.shape[1] // 8
    blocks = (mb & 1).astype(np.uint8).reshape(R, 8, K, 8).transpose(
        0, 2, 1, 3)
    eye = (blocks == np.eye(8, dtype=np.uint8)).all(axis=(2, 3))
    zero = ~blocks.any(axis=(2, 3))
    return eye.astype(np.uint8) if (eye | zero).all() else None


def mask_words(mbits, kw: int) -> np.ndarray:
    """uint32 [8R, kw]: bit i of word q of row r is ``mbits[r, 32q+i]``
    mod 2, zero past the 8K columns.  So word q covers input rows
    4q..4q+3, bit 8j+b standing for bit b of input row 4q+j: the layout
    the kernel gives each column's bits."""
    mb = np.asarray(mbits)
    bits = np.zeros((mb.shape[0], 32 * kw), dtype=np.uint8)
    bits[:, :mb.shape[1]] = mb & 1
    words = np.packbits(bits, axis=1, bitorder="little")
    return np.ascontiguousarray(words).view("<u4").astype(np.uint32)


def mma_fragments(words: np.ndarray) -> np.ndarray:
    """Mask words [8R, kw] in the order of the B fragments of
    ``mma.m16n8k256.b1``: uint32 [R, kw/8, 32, 2], where lane
    (g = lane>>2, t = lane&3) of step s for output byte row i holds words
    8s+t and 8s+t+4 of matrix row 8i+g (output bit g)."""
    r8, kw = words.shape
    f = words.reshape(r8 // 8, 8, kw // 8, 2, 4)   # [i, g, s, h, t]
    return np.ascontiguousarray(f.transpose(0, 2, 1, 4, 3)).reshape(
        r8 // 8, kw // 8, 32, 2)


def prepare_bitmatrix(matrix, w: int = 8) -> np.ndarray:
    """Host: a GF(2^w) coding matrix -> the int8 GF(2) bit-matrix
    operand."""
    return gf.matrix_to_bitmatrix(np.asarray(matrix), w).astype(np.int8)


# ---------------------------------------------------------------------------
# the kernel's operand and launch
# ---------------------------------------------------------------------------


class BitOperand:
    """A bit-matrix ready for the kernels: ``mbits`` int8 [8R, 8K].

    Its structure picks the kernel, once, here.  When every 8x8 block is
    zero or the identity (``packet`` is the [R, K] 0/1 matrix), the
    product is a XOR of whole packet rows: the operand keeps, per output
    row, the list of input rows it XORs (CSR: ``rowptr`` int32 [R+1],
    ``idx`` u8), sent to each device once, and the XOR kernel runs.
    Otherwise its rows are packed into u32 mask words [8R, kw] (bit i of
    word q = column 32q+i, taken mod 2 as the int32 product is), laid out
    as the mma's B fragments (:func:`mma_fragments`), sent to each device
    once, and the popcount kernel runs.  Codecs keep one per matrix."""

    def __init__(self, mbits) -> None:
        mb = np.ascontiguousarray(np.asarray(mbits), dtype=np.int8)
        if mb.ndim != 2 or mb.shape[0] % 8 or mb.shape[1] % 8 or \
                not mb.size:
            raise ValueError(f"bit-matrix must be [8R, 8K], got {mb.shape}")
        self.mbits = mb
        self.R, self.K = mb.shape[0] // 8, mb.shape[1] // 8
        # the XOR kernel's u8 lists name at most MAX_XOR_K input rows
        self.packet = packet_matrix(mb) if self.K <= MAX_XOR_K else None
        if self.packet is not None:
            rows, cols = np.nonzero(self.packet)
            self.rowptr = np.searchsorted(
                rows, np.arange(self.R + 1)).astype(np.int32)
            self.idx = cols.astype(np.uint8)
        self._masks = {}
        self._lists = {}
        self._lock = threading.Lock()

    @property
    def kw(self) -> int:
        need = -(-self.K // 4)
        for kw in KW_BUCKETS:
            if need <= kw:
                return kw
        raise ValueError(f"gf2 kernel takes K <= {MAX_K} input rows, got "
                         f"{self.K}")

    def masks(self, device: torch.device) -> torch.Tensor:
        """The popcount kernel's operand on ``device``: int32 [R, kw/8,
        32, 2], the mask words in mma fragment order, copied there
        once."""
        with self._lock:
            got = self._masks.get(device)
            if got is None:
                frags = mma_fragments(mask_words(self.mbits, self.kw))
                # a synchronous copy: the masks are whole before any
                # stream uses them
                got = torch.from_numpy(frags.view(np.int32)).to(device)
                self._masks[device] = got
            return got

    def packet_lists(self, device: torch.device):
        """(rowptr int32 [R+1], idx uint8 [nnz]) on ``device``, copied
        there once."""
        if self.packet is None:
            raise ValueError("not a 0/1 packet operand")
        with self._lock:
            got = self._lists.get(device)
            if got is None:
                # synchronous copies: whole before any stream uses them
                got = (torch.from_numpy(self.rowptr).to(device),
                       torch.from_numpy(self.idx).to(device))
                self._lists[device] = got
            return got


def operand(mbits) -> BitOperand:
    return mbits if isinstance(mbits, BitOperand) else BitOperand(mbits)


def _check_rows(t: torch.Tensor, rows: int, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor (its device "
                        "decides where the product runs)")
    if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{what} must be uint8 [{rows}, n], got "
                         f"{tuple(t.shape)} {t.dtype}")


def _launch(op: BitOperand, x: torch.Tensor, out: torch.Tensor,
            offs: np.ndarray, widths: np.ndarray, w: int) -> None:
    """One popcount-kernel launch on the current stream for at most
    MAX_JOBS jobs.  It takes any operand; the main path sends it only
    those that are not 0/1 packet matrices.  ``out`` may be ``x`` itself
    (R == K, the same rows): a warp reads every input row of its columns
    before it writes them."""
    kw = op.kw
    smem = (op.K + op.R) * 8  # the job's row offsets
    if smem > DEFAULT_SMEM:
        raise ValueError(f"gf2 kernel: a {8 * op.R}x{8 * op.K} bit-matrix "
                         f"needs {smem} bytes of shared memory, more than "
                         f"{DEFAULT_SMEM}")
    masks = op.masks(x.device)
    err = _build.lib().gf2_matmul_launch(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
        offs.ctypes.data, widths.ctypes.data, len(offs), w, op.K, op.R,
        masks.data_ptr(), kw, torch.cuda.current_stream(x.device).cuda_stream)
    launches.inc()
    _build.check(err, "gf2_matmul")


def _launch_xor(op: BitOperand, x: torch.Tensor, out: torch.Tensor,
                offs: np.ndarray, widths: np.ndarray, w: int) -> None:
    """One XOR-kernel launch on the current stream for at most MAX_JOBS
    jobs of a 0/1 packet operand.  ``out`` may be ``x`` itself (R == K,
    the same rows): a block stages every input row of its column tile
    before it writes that tile."""
    smem = 2 * op.K * XOR_TILE + (op.K + op.R) * 8
    if smem > MAX_SMEM:
        raise ValueError(f"gf2 XOR kernel: K={op.K} input rows need {smem} "
                         f"bytes of shared memory, more than {MAX_SMEM}")
    rowptr, idx = op.packet_lists(x.device)
    err = _build.lib().gf2_xor_packets_launch(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
        offs.ctypes.data, widths.ctypes.data, len(offs), w, op.K, op.R,
        rowptr.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    xor_launches.inc()
    _build.check(err, "gf2_xor")


def gf2_matmul_packets(mbits, x: torch.Tensor, out: torch.Tensor,
                       offs: Sequence[int], widths: Sequence[int],
                       w: int) -> torch.Tensor:
    """Batched packet product, written into ``out`` and returned.

    ``x`` uint8 [kin, P] and ``out`` uint8 [rout, P] on one device, the
    bit-matrix [8*rout*w, 8*kin*w].  For each job (off, width), width a
    multiple of w: logical input row c*w+p is
    ``x[c, off + p*width/w : off + (p+1)*width/w]`` and logical output
    row i*w+q lands in the same place of ``out``.  Columns outside the
    jobs are left as they were."""
    op = operand(mbits)
    w = int(w)
    if w < 1 or op.K % w or op.R % w:
        raise ValueError(f"a {8 * op.R}x{8 * op.K} bit-matrix does not act "
                         f"on whole groups of w={w} packets")
    _check_rows(x, op.K // w, "x")
    _check_rows(out, op.R // w, "out")
    P = x.shape[1]
    if out.shape[1] != P or out.device != x.device:
        raise ValueError(f"out must be uint8 [{op.R // w}, {P}] on "
                         f"{x.device}")
    offs = np.asarray(offs, dtype=np.int64).reshape(-1)
    widths = np.asarray(widths, dtype=np.int64).reshape(-1)
    if offs.shape != widths.shape:
        raise ValueError("offs and widths need one entry per job")
    if (offs < 0).any() or (widths < 0).any() or (offs + widths > P).any():
        raise ValueError(f"job extents must lie inside the {P} columns")
    if (widths % w).any():
        raise ValueError(f"every job width must be a multiple of w={w}")
    packet = op.packet is not None  # the structure picks the kernel
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gf2_matmul runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and out.stride(1) != 1:
        raise ValueError("out must have unit column stride")
    return instrumented_launch(
        "gf2_xor" if packet else "gf2_matmul",
        signature((x, out, w), {}, static_argnums=(2,)),
        lambda: _packets(op, x, out, offs, widths, w, packet), x.device)


def _packets(op: "BitOperand", x: torch.Tensor, out: torch.Tensor,
             offs: np.ndarray, widths: np.ndarray, w: int,
             packet: bool) -> torch.Tensor:
    """:func:`gf2_matmul_packets` after its checks."""
    if x.device.type == "cpu":
        plain = gf2_xor_packets_plain if packet else gf2_matmul_packets_plain
        return plain(op, x, out, offs, widths, w)
    if x.stride(1) != 1:
        x = x.contiguous()
    launch = _launch_xor if packet else _launch
    for s in range(0, len(offs), MAX_JOBS):
        launch(op, x, out, np.ascontiguousarray(offs[s:s + MAX_JOBS]),
                np.ascontiguousarray(widths[s:s + MAX_JOBS]), w)
    return out


def gf2_matmul_bytes(mbits, x: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the GF(2) bit-matrix [8R, 8K] (int8 array or
    :class:`BitOperand`) to byte rows x [K, n]: uint8 [R, n] on x's
    device, written into ``out`` when given."""
    op = operand(mbits)
    _check_rows(x, op.K, "x")
    n = x.shape[1]
    if out is None:
        out = torch.empty((op.R, n), dtype=torch.uint8, device=x.device)
    return gf2_matmul_packets(op, x, out, [0], [n], 1)
