"""Covering buckets: the one padding rule every batch dispatch uses.

Port of the covering grammar of ``ceph_tpu/tpu/shapebucket.py:65-90``.
A coalesced batch's width is padded up to ``gran * 2**j`` so the set of
widths the device sees stays small and declared.  (``BucketSpec``,
``DeviceWarmup`` and the compile cache of the JAX module wait for a
later slice.)
"""

from __future__ import annotations


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
