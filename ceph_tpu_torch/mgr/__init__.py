"""Manager-plane services: placement balancing over the full-pool sweep
(reference: src/mgr/ + src/pybind/mgr/balancer/).  Port of
``ceph_tpu/mgr/__init__.py``: the same exports."""

from ceph_tpu_torch.mgr.balancer import BalanceReport, UpmapBalancer

__all__ = ["UpmapBalancer", "BalanceReport"]
