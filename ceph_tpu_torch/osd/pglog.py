"""PGLog — the per-PG ordered mutation log behind replication and
recovery.

Port of ``ceph_tpu/osd/pglog.py`` (reference: src/osd/PGLog.{h,cc}, the
IndexedLog).  Every write appends a LogEntry in the same ObjectStore
transaction as its data (the log_operation discipline,
src/osd/ECBackend.cc:924).  Peers compare (log_tail, head] ranges: a
replica inside the primary's range catches up by replaying the missing
entries' objects; one behind the tail needs backfill.

The entries live in the PG meta object's omap, keyed by a zero-padded
version string; keys and values are the reference's bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.core.failpoint import failpoint
from ceph_tpu_torch.osd.types import EVersion, LogEntry

MAX_LOG_ENTRIES = 3000  # osd_max_pg_log_entries role


def _logkey(v: EVersion) -> str:
    return f"{v.epoch:010d}.{v.version:020d}"


def rollback_key(v: EVersion, shard: int) -> str:
    """PG-meta omap key of one shard's rollback record for the entry at
    `v` (the ECTransaction rollback-extents role): written in the same
    transaction as the entry, consumed by divergent-entry rollback,
    trimmed with the entry.  The "rb_" prefix keeps it out of
    from_omap's digit-keyed scan."""
    return f"rb_{_logkey(v)}.{shard}"


def rollback_prefix(v: EVersion) -> str:
    """Prefix matching every shard's rollback record for `v`."""
    return f"rb_{_logkey(v)}."


class PGLog:
    def __init__(self) -> None:
        self.entries: List[LogEntry] = []
        self.tail = EVersion()  # everything <= tail is pruned
        self.head = EVersion()

    # -- mutation ---------------------------------------------------------
    def append(self, entry: LogEntry) -> None:
        if entry.version <= self.head:
            raise ValueError(
                f"log must advance: {entry.version} <= {self.head}")
        self.entries.append(entry)
        self.head = entry.version

    def trim_to(self, keep: int = MAX_LOG_ENTRIES) -> List[LogEntry]:
        """Prune the oldest entries beyond `keep`; returns them."""
        if len(self.entries) <= keep:
            return []
        cut = len(self.entries) - keep
        trimmed = self.entries[:cut]
        self.entries = self.entries[cut:]
        self.tail = trimmed[-1].version
        return trimmed

    def rewind_to(self, target: EVersion) -> List[LogEntry]:
        """Drop entries strictly newer than `target` (the reference's
        rewind_divergent_log).  Returns the divergent entries newest
        first, the order their rollbacks must run in."""
        divergent = [en for en in self.entries if en.version > target]
        if not divergent:
            return []
        failpoint("pglog.rewind", target=str(target), n=len(divergent))
        self.entries = [en for en in self.entries if en.version <= target]
        self.head = (self.entries[-1].version if self.entries
                     else self.tail)
        return list(reversed(divergent))

    # -- queries ----------------------------------------------------------
    def latest_for(self, oid: str) -> Optional[LogEntry]:
        """The newest entry touching `oid`, or None."""
        for en in reversed(self.entries):
            if en.oid == oid:
                return en
        return None

    def entries_after(self, v: EVersion) -> Optional[List[LogEntry]]:
        """Entries strictly newer than v, or None if v fell behind the
        tail (backfill)."""
        if v < self.tail:
            return None
        return [en for en in self.entries if en.version > v]

    def objects_changed_after(
            self, v: EVersion) -> Optional[Dict[str, LogEntry]]:
        """The latest entry per object after v (None: backfill)."""
        ents = self.entries_after(v)
        if ents is None:
            return None
        return {en.oid: en for en in ents}

    # -- persistence ------------------------------------------------------
    def omap_additions(self, entries: List[LogEntry]) -> Dict[str, bytes]:
        out = {}
        for en in entries:
            e = Encoder()
            en.encode(e)
            out[_logkey(en.version)] = e.bytes()
        return out

    def omap_removals(self, trimmed: List[LogEntry]) -> List[str]:
        return [_logkey(en.version) for en in trimmed]

    @classmethod
    def from_omap(cls, omap: Dict[str, bytes]) -> "PGLog":
        log = cls()
        for key in sorted(k for k in omap if k[0].isdigit()):
            log.entries.append(LogEntry.decode(Decoder(omap[key])))
        if log.entries:
            log.head = log.entries[-1].version
            log.tail = EVersion(
                log.entries[0].version.epoch,
                max(0, log.entries[0].version.version - 1),
            )
        return log

    def __len__(self) -> int:
        return len(self.entries)
