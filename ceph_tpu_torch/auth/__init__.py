"""Authentication: cephx-role tickets over shared-secret keyrings
(reference: src/auth/, src/auth/cephx/).

Port of ``ceph_tpu/auth/``, with the same ``__all__``."""

from ceph_tpu_torch.auth.cephx import (
    AuthError,
    CephxClient,
    CephxServer,
    Ticket,
    seal,
    unseal,
    verify_authorizer,
)
from ceph_tpu_torch.auth.keyring import Keyring, generate_secret

__all__ = ["AuthError", "CephxClient", "CephxServer", "Ticket",
           "Keyring", "generate_secret", "seal", "unseal",
           "verify_authorizer"]
