"""Cluster control plane: the monitor's wire messages, its roster and
the client daemons find it through.

Port of ``ceph_tpu/mon/``: ``messages``, ``MonMap`` (``monitor.py``,
the roster only) and ``MonClient`` (``client.py``).  The monitor itself
(``Monitor``: election, Paxos, the OSDMonitor service) is ROADMAP queue
1 item 6 of the port; until then the port's daemons boot through the
reference's monitors (``tests/test_torch_monclient.py``).
"""

from ceph_tpu_torch.mon.monitor import MonMap  # noqa: F401
from ceph_tpu_torch.mon.client import MonClient  # noqa: F401
