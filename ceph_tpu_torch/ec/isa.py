"""isa-equivalent plugin: ISA-L matrix semantics on the port's product.

Port of ``ceph_tpu/ec/isa.py`` (reference: src/erasure-code/isa/
ErasureCodeIsa.{h,cc}): technique ``reed_sol_van`` (gf_gen_rs_matrix)
or ``cauchy`` (gf_gen_cauchy1_matrix), with the reference's k/m ranges
for the Vandermonde matrix (k <= 32, m <= 4, k <= 21 when m = 4;
ErasureCodeIsa.cc:330-360).
"""

from __future__ import annotations

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.codec import RSMatrixCodec
from ceph_tpu_torch.ec.interface import ErasureCodeError, to_int

DEFAULT_K = 7
DEFAULT_M = 3


class ErasureCodeIsa:
    TECHNIQUES = ("reed_sol_van", "cauchy")

    @staticmethod
    def create(profile: dict, device=None) -> RSMatrixCodec:
        technique = profile.get("technique", "reed_sol_van")
        k = to_int(profile, "k", DEFAULT_K)
        m = to_int(profile, "m", DEFAULT_M)
        if k < 2:
            raise ErasureCodeError("k must be >= 2")
        if technique == "reed_sol_van":
            if k > 32:
                raise ErasureCodeError("isa vandermonde: k must be <= 32")
            if m > 4:
                raise ErasureCodeError("isa vandermonde: m must be <= 4")
            if m == 4 and k > 21:
                raise ErasureCodeError("isa vandermonde: k<=21 when m=4")
            coding = matrices.isa_rs_vandermonde(k, m)
        elif technique == "cauchy":
            coding = matrices.isa_cauchy(k, m)
        else:
            raise ErasureCodeError(f"unknown isa technique {technique!r}")
        codec = RSMatrixCodec(k, m, coding, device=device)
        codec.init(profile)
        return codec
