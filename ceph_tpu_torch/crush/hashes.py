"""rjenkins1 32-bit hash family: numpy and PyTorch twins.

Port of ``ceph_tpu/crush/hashes.py``, the bit-exact crush_hash32*
functions (reference: src/crush/hash.c:12-90).  Each function takes an
array namespace ``xp``:

- ``xp=np`` (the default) computes in numpy uint32, whose wraparound is
  the C's;
- ``xp=torch`` computes on tensors of any integer type, on their device.
  PyTorch's uint32 is thin (several ops are missing on CUDA), so the
  torch twin computes in int64 and masks to 32 bits after every step
  that can leave them, as ``ops/mix32.py`` does, and returns int64
  tensors holding the u32 values.

``csrc/crush.cu`` has the same functions in CUDA C++; the rule walk's
plain version (``ops/crush_rule.py``) runs the torch twins.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

CRUSH_HASH_SEED = 1315423911  # reference: src/crush/hash.c:24
CRUSH_HASH_RJENKINS1 = 0
_M32 = 0xFFFFFFFF


def _quiet(xp):
    """uint32 wraparound is intended; silence numpy scalar warnings."""
    if xp is np:
        return np.errstate(over="ignore")
    return contextlib.nullcontext()


def _mix_np(a, b, c):
    """One crush_hashmix round (reference: src/crush/hash.c:12-22)."""
    u32 = lambda v: v.astype(np.uint32) if hasattr(v, "astype") \
        else np.uint32(v)  # noqa: E731
    a, b, c = u32(a), u32(b), u32(c)
    a = a - b
    a = a - c
    a = a ^ (c >> 13)
    b = b - c
    b = b - a
    b = b ^ (a << 8)
    c = c - a
    c = c - b
    c = c ^ (b >> 13)
    a = a - b
    a = a - c
    a = a ^ (c >> 12)
    b = b - c
    b = b - a
    b = b ^ (a << 16)
    c = c - a
    c = c - b
    c = c ^ (b >> 5)
    a = a - b
    a = a - c
    a = a ^ (c >> 3)
    b = b - c
    b = b - a
    b = b ^ (a << 10)
    c = c - a
    c = c - b
    c = c ^ (b >> 15)
    return a, b, c


def _mix_torch(a, b, c):
    """The same round on int64 tensors holding u32 values."""
    a = ((a - b - c) & _M32) ^ (c >> 13)
    b = ((b - c - a) & _M32) ^ ((a << 8) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 13)
    a = ((a - b - c) & _M32) ^ (c >> 12)
    b = ((b - c - a) & _M32) ^ ((a << 16) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 5)
    a = ((a - b - c) & _M32) ^ (c >> 3)
    b = ((b - c - a) & _M32) ^ ((a << 10) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 15)
    return a, b, c


def _args(xp, vals):
    """The hash inputs as u32 values of namespace xp, broadcast."""
    if xp is torch:
        ts = [v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
              for v in vals]
        dev = next((t.device for t in ts if t.dim()), ts[0].device)
        return [t.to(device=dev, dtype=torch.int64) & _M32 for t in ts]
    return [np.asarray(v).astype(np.uint32) for v in vals]


def _consts(xp):
    if xp is torch:
        return CRUSH_HASH_SEED, 231232, 1232, _mix_torch
    return (np.uint32(CRUSH_HASH_SEED), np.uint32(231232), np.uint32(1232),
            _mix_np)


def _const_like(v, like):
    """A hash constant shaped for the mix (torch needs a tensor)."""
    if isinstance(like, torch.Tensor):
        return torch.full_like(like, int(v))
    return v


def hash32(a, xp=np):
    with _quiet(xp):
        (a,) = _args(xp, (a,))
        seed, x0, y0, mix = _consts(xp)
        h = a ^ seed
        b = a
        x, y = _const_like(x0, a), _const_like(y0, a)
        b, x, h = mix(b, x, h)
        y, a, h = mix(y, a, h)
        return h


def hash32_2(a, b, xp=np):
    with _quiet(xp):
        a, b = _args(xp, (a, b))
        seed, x0, y0, mix = _consts(xp)
        h = a ^ b ^ seed
        x, y = _const_like(x0, h), _const_like(y0, h)
        a, b, h = mix(a, b, h)
        x, a, h = mix(x, a, h)
        b, y, h = mix(b, y, h)
        return h


def hash32_3(a, b, c, xp=np):
    with _quiet(xp):
        a, b, c = _args(xp, (a, b, c))
        seed, x0, y0, mix = _consts(xp)
        h = a ^ b ^ c ^ seed
        x, y = _const_like(x0, h), _const_like(y0, h)
        a, b, h = mix(a, b, h)
        c, x, h = mix(c, x, h)
        y, a, h = mix(y, a, h)
        b, x, h = mix(b, x, h)
        y, c, h = mix(y, c, h)
        return h


def hash32_4(a, b, c, d, xp=np):
    with _quiet(xp):
        a, b, c, d = _args(xp, (a, b, c, d))
        seed, x0, y0, mix = _consts(xp)
        h = a ^ b ^ c ^ d ^ seed
        x, y = _const_like(x0, h), _const_like(y0, h)
        a, b, h = mix(a, b, h)
        c, d, h = mix(c, d, h)
        a, x, h = mix(a, x, h)
        y, b, h = mix(y, b, h)
        c, x, h = mix(c, x, h)
        y, d, h = mix(y, d, h)
        return h


def hash32_5(a, b, c, d, e, xp=np):
    with _quiet(xp):
        a, b, c, d, e = _args(xp, (a, b, c, d, e))
        seed, x0, y0, mix = _consts(xp)
        h = a ^ b ^ c ^ d ^ e ^ seed
        x, y = _const_like(x0, h), _const_like(y0, h)
        a, b, h = mix(a, b, h)
        c, d, h = mix(c, d, h)
        e, x, h = mix(e, x, h)
        y, a, h = mix(y, a, h)
        b, x, h = mix(b, x, h)
        y, c, h = mix(y, c, h)
        d, x, h = mix(d, x, h)
        y, e, h = mix(y, e, h)
        return h


def str_hash_rjenkins(name: bytes) -> int:
    """ceph_str_hash_rjenkins — the object-name hash feeding pg selection.

    Bit-exact port of the reference's string rjenkins
    (reference: src/common/ceph_hash.cc: ceph_str_hash_rjenkins), used by
    pg_pool_t::hash_key (reference: src/osd/osd_types.cc:1468).
    """
    if isinstance(name, str):
        name = name.encode()
    length = len(name)
    a = np.uint32(0x9E3779B9)
    b = np.uint32(0x9E3779B9)
    c = np.uint32(0)
    pos = 0
    ln = length
    with _quiet(np):
        while ln >= 12:
            k = name[pos: pos + 12]
            a = a + np.uint32(k[0] + (k[1] << 8) + (k[2] << 16) + (k[3] << 24))
            b = b + np.uint32(k[4] + (k[5] << 8) + (k[6] << 16) + (k[7] << 24))
            c = c + np.uint32(k[8] + (k[9] << 8) + (k[10] << 16)
                              + (k[11] << 24))
            a, b, c = _mix_np(a, b, c)
            pos += 12
            ln -= 12
        # last <= 11 bytes; fall-through switch, first byte of c reserved
        # for the length
        c = c + np.uint32(length)
        k = name[pos:]
        if ln >= 11:
            c = c + np.uint32(k[10] << 24)
        if ln >= 10:
            c = c + np.uint32(k[9] << 16)
        if ln >= 9:
            c = c + np.uint32(k[8] << 8)
        if ln >= 8:
            b = b + np.uint32(k[7] << 24)
        if ln >= 7:
            b = b + np.uint32(k[6] << 16)
        if ln >= 6:
            b = b + np.uint32(k[5] << 8)
        if ln >= 5:
            b = b + np.uint32(k[4])
        if ln >= 4:
            a = a + np.uint32(k[3] << 24)
        if ln >= 3:
            a = a + np.uint32(k[2] << 16)
        if ln >= 2:
            a = a + np.uint32(k[1] << 8)
        if ln >= 1:
            a = a + np.uint32(k[0])
        a, b, c = _mix_np(a, b, c)
    return int(c)
