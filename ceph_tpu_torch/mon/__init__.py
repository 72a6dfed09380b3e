"""Cluster control plane: the Paxos-replicated map service.

Port of ``ceph_tpu/mon/`` (reference src/mon/): the monitor's wire
messages (``messages``), ``Monitor`` with leader election, Paxos and
the OSDMonitor service, and ``MonMap`` (``monitor.py``), the
PaxosService family (``services.py``), the PGMap digest (``pgmap.py``)
and the ``MonClient`` daemons and clients find the quorum through
(``client.py``).  The OSDMap is the Paxos-committed value; OSDs boot
and report failures through the mon, and everyone subscribes to map
updates.
"""

from ceph_tpu_torch.mon.monitor import (  # noqa: F401
    STATE_ELECTING,
    STATE_LEADER,
    STATE_PEON,
    MonMap,
    Monitor,
)
from ceph_tpu_torch.mon.client import MonClient  # noqa: F401
