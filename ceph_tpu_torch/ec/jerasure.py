"""jerasure-equivalent plugin: the Reed-Solomon techniques.

Port of the RS half of ``ceph_tpu/ec/jerasure.py:169-226`` (reference:
src/erasure-code/jerasure/ErasureCodeJerasure.h:82-112):
``reed_sol_van`` and ``reed_sol_r6_op``.  The bit-matrix techniques
(cauchy_orig, cauchy_good, liberation, blaum_roth, liber8tion) run on the
GF(2) bit-matrix kernel, which a later slice of the port brings; until
then they raise.
"""

from __future__ import annotations

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.codec import RSMatrixCodec
from ceph_tpu_torch.ec.interface import ErasureCodeError, to_int

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8

BITMATRIX_TECHNIQUES = ("cauchy_orig", "cauchy_good", "liberation",
                        "blaum_roth", "liber8tion")


class ErasureCodeJerasure:
    """Factory facade: pick the technique, return a configured codec."""

    TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op") + BITMATRIX_TECHNIQUES

    @staticmethod
    def create(profile: dict, device=None) -> RSMatrixCodec:
        technique = profile.get("technique", "reed_sol_van")
        k = to_int(profile, "k", DEFAULT_K)
        m = to_int(profile, "m", DEFAULT_M)
        w = to_int(profile, "w", DEFAULT_W)
        if k < 2:
            raise ErasureCodeError("k must be >= 2")
        if technique == "reed_sol_van":
            if w != 8:
                raise ErasureCodeError("reed_sol_van currently supports w=8")
            codec = RSMatrixCodec(k, m, matrices.jerasure_rs_vandermonde(k, m),
                                  device=device)
        elif technique == "reed_sol_r6_op":
            if m != 2:
                raise ErasureCodeError("reed_sol_r6_op requires m=2")
            codec = RSMatrixCodec(k, 2, matrices.jerasure_rs_r6(k),
                                  device=device)
        elif technique in BITMATRIX_TECHNIQUES:
            raise ErasureCodeError(
                f"jerasure technique {technique!r} runs on the GF(2) "
                "bit-matrix kernel, not ported yet (a later slice of the "
                "port: ROADMAP queue 1, bit-matrix engine)")
        else:
            raise ErasureCodeError(f"unknown technique {technique!r}")
        codec.init(profile)
        return codec
