"""Fixed-point crush_ln and the straw2 draw: numpy and PyTorch twins.

Port of ``ceph_tpu/crush/ln.py``.  crush_ln computes 2^44 * log2(x + 1)
with the interpolation tables in ln_table.py (reference:
src/crush/mapper.c:248-290).  The straw2 draw is
  ln(hash3(x, id, r) & 0xffff) - 2^48, divided (signed, truncating) by the
16.16 item weight, or S64_MIN for a zero weight (reference:
src/crush/mapper.c:334-375).

Because the hash is masked to 16 bits, crush_ln over the straw2 domain
has exactly 65536 distinct outputs; :func:`ln16_table` tabulates them
once, and the torch draw gathers from it.  Every function takes
``xp=np`` (the default) or ``xp=torch``; the torch twins compute in
int64 on the tensors' device.

:func:`fastcmp_bounds` is the reference's proof that a hash order is a
draw order: in a bucket whose items share one weight w <= bound[2], a
16-bit hash at least 2 above another always draws strictly higher.  The
reference uses it to flag near ties for a later exact stage; the port's
kernel (``csrc/crush.cu``) settles a near tie in place with the exact
draw, so its draws stay exact and only hash distances below 2 or
unequal weights pay for crush_ln and the divide.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.crush.ln_table import LL_TBL, RH_LH_TBL

_RH_LH = np.asarray(RH_LH_TBL, dtype=np.uint64)
_LL = np.asarray(LL_TBL, dtype=np.uint64)
S64_MIN = -0x8000000000000000


def crush_ln(xin, xp=np):
    """Bit-exact crush_ln over inputs in [0, 0x10000): int64 values."""
    if xp is torch:
        return _crush_ln_torch(xin)
    x = np.asarray(xin).astype(np.uint32) + np.uint32(1)
    # normalize: shift x so its highest set bit lands at position >= 15;
    # mirrors the clz branch at mapper.c:261-265 (x <= 0x10000 here).
    hb = np.zeros(x.shape, dtype=np.int32)
    xs = x.astype(np.int64)
    for b in (16, 8, 4, 2, 1):
        over = (xs >> b) > 0
        hb = hb + np.where(over, np.int32(b), np.int32(0))
        xs = np.where(over, xs >> b, xs)
    bits = np.maximum(np.int32(15) - hb, np.int32(0))
    x = (x.astype(np.int64) << bits.astype(np.int64)).astype(np.uint32)
    iexpon = (np.int32(15) - bits).astype(np.int64)

    index1 = (x >> 8).astype(np.int64) * 2
    RH = _RH_LH[index1 - 256]
    LH = _RH_LH[index1 + 1 - 256]

    xl64 = (x.astype(np.uint64) * RH) >> np.uint64(48)
    result = iexpon.astype(np.uint64) << np.uint64(12 + 32)

    index2 = (xl64 & np.uint64(0xFF)).astype(np.int64)
    LL = _LL[index2]
    LH = (LH + LL) >> np.uint64(48 - 12 - 32)
    return (result + LH).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(RH_LH, LL) as int64 tensors on ``device`` (every entry < 2^63)."""
    return (torch.from_numpy(_RH_LH.astype(np.int64)).to(device),
            torch.from_numpy(_LL.astype(np.int64)).to(device))


def _crush_ln_torch(xin: torch.Tensor) -> torch.Tensor:
    x = xin.to(torch.int64) + 1
    hb = torch.zeros_like(x)
    xs = x
    for b in (16, 8, 4, 2, 1):
        over = (xs >> b) > 0
        hb = hb + over.to(torch.int64) * b
        xs = torch.where(over, xs >> b, xs)
    bits = torch.clamp(15 - hb, min=0)
    x = x << bits
    iexpon = 15 - bits
    rh_lh, ll = _tables(x.device)
    index1 = (x >> 8) * 2
    RH = rh_lh[index1 - 256]
    LH = rh_lh[index1 + 1 - 256]
    # (x * RH) >> 48 can pass 2^63 (x < 2^17, RH <= 2^48): split RH at
    # bit 16 so that every product stays inside int64
    xl64 = (x * (RH >> 16) + ((x * (RH & 0xFFFF)) >> 16)) >> 32
    LL = ll[xl64 & 0xFF]
    LH = (LH + LL) >> (48 - 12 - 32)
    return (iexpon << (12 + 32)) + LH


@functools.lru_cache(maxsize=None)
def ln16_table() -> np.ndarray:
    """int64[65536]: crush_ln(u) - 2^48 for every 16-bit hash value.

    These are the (negative) log values straw2 divides by the item
    weight."""
    u = np.arange(0x10000, dtype=np.uint32)
    return (crush_ln(u) - np.int64(0x1000000000000)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def ln16_tensor(device: torch.device) -> torch.Tensor:
    """:func:`ln16_table` as an int64 tensor on ``device``."""
    return torch.from_numpy(ln16_table()).to(device)


@functools.lru_cache(maxsize=None)
def fastcmp_bounds() -> dict:
    """{delta: bound}: for every pair of 16-bit hash values u_i < u_j
    with u_j - u_i >= delta, the straw2 magnitudes satisfy
    n(u_i) - n(u_j) >= bound, where n(u) = 2^48 - crush_ln(u).

    crush_ln's fixed-point interpolation is not monotone (adjacent
    values can invert), but the inversion is local: at distance >= 2
    the magnitudes separate by more than 2^25.  So in a bucket whose
    items share one positive weight w <= bound[d], floor(n_i / w) >
    floor(n_j / w) (as a - b >= w gives floor(a/w) > floor(b/w)): the
    item with the higher hash draws strictly higher.

    Computed exactly from the table by a suffix maximum: bound[d] =
    min_u [n(u) - max_{v >= u+d} n(v)].  A copy of
    ``ceph_tpu/crush/ln.py:70-93``.
    """
    n = (-ln16_table()).astype(np.int64)
    sm = np.maximum.accumulate(n[::-1])[::-1]
    return {d: int((n[:-d] - sm[d:]).min()) for d in (2, 3, 4)}


def div64_trunc(num, den, xp=np):
    """C-style truncating signed 64-bit division (div64_s64 semantics).

    numpy integer ``//`` floors; C truncates toward zero.  num is the
    (negative) ln value, den the positive 16.16 weight.
    """
    if xp is torch:
        return torch.div(num.to(torch.int64), den.to(torch.int64),
                         rounding_mode="trunc")
    num = np.asarray(num).astype(np.int64)
    den = np.asarray(den).astype(np.int64)
    q = np.abs(num) // den
    return np.where(num < 0, -q, q)


def straw2_draw(hash16, weight, xp=np):
    """draw = div64_s64(crush_ln(u) - 2^48, weight); S64_MIN if weight==0.

    hash16: the (hash & 0xffff) values; weight: the 16.16 weights.
    reference: src/crush/mapper.c:334-375.
    """
    if xp is torch:
        ln = ln16_tensor(hash16.device)[hash16.to(torch.int64)]
        weight = weight.to(torch.int64)
        draw = div64_trunc(ln, torch.clamp(weight, min=1), xp=torch)
        return torch.where(weight == 0, torch.full_like(draw, S64_MIN),
                           draw)
    ln = ln16_table()[np.asarray(hash16).astype(np.int64)]
    weight = np.asarray(weight).astype(np.int64)
    draw = div64_trunc(ln, np.maximum(weight, np.int64(1)))
    return np.where(weight == 0, np.int64(S64_MIN), draw)
