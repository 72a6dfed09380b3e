"""Client library: Objecter (placement + resend engine) and the
librados-style RadosClient/IoCtx facade (reference: src/osdc/,
src/librados/).

Port of ``ceph_tpu/client/``."""

from ceph_tpu_torch.client.objecter import Objecter, ObjecterOp
from ceph_tpu_torch.client.rados import IoCtx, RadosClient, RadosError

__all__ = ["Objecter", "ObjecterOp", "RadosClient", "IoCtx", "RadosError"]
