"""MonMap: the versioned roster of monitors (reference src/mon/MonMap.h).

Port of ``MonMap`` of ``ceph_tpu/mon/monitor.py:44-84``, which
``MonClient`` (``mon/client.py``) finds the quorum through.  The rest of
that module (``Monitor``: election, Paxos and the OSDMonitor service)
is ROADMAP queue 1 item 6 of the port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Addr = Tuple[str, int]


class MonMap:
    """Versioned mon roster: rank -> address (reference MonMap).
    Mutations go through the MonmapMonitor paxos service, which
    REPLACES a monitor's monmap rather than mutating a (possibly
    shared) instance."""

    def __init__(self, addrs: List[Optional[Addr]], epoch: int = 1) -> None:
        # a removed rank leaves a None HOLE: ranks are identity (baked
        # into entity names and running sessions), so they never shift
        self.addrs = [tuple(a) if a is not None else None for a in addrs]
        self.epoch = epoch

    @property
    def size(self) -> int:
        return len(self.addrs)  # rank slots, incl. holes

    def live_ranks(self) -> List[int]:
        return [r for r, a in enumerate(self.addrs) if a is not None]

    def quorum(self) -> int:
        return len(self.live_ranks()) // 2 + 1

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "addrs": [list(a) if a is not None else None
                          for a in self.addrs]}

    @classmethod
    def from_dict(cls, d: dict) -> "MonMap":
        return cls([tuple(a) if a is not None else None
                    for a in d["addrs"]], epoch=d["epoch"])

    def with_added(self, addr: Addr) -> "MonMap":
        return MonMap(self.addrs + [tuple(addr)], epoch=self.epoch + 1)

    def with_removed(self, rank: int) -> "MonMap":
        addrs = list(self.addrs)
        addrs[rank] = None
        return MonMap(addrs, epoch=self.epoch + 1)
