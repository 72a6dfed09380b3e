"""Probe for F4: the EC model sequence under the OSD thrasher
(``test_rados_model.py:409``) on one package's six-daemon cluster, with
every divergent-entry rollback that found no rollback record traced.

    JAX_PLATFORMS=cpu python tests/torch_f4_probe.py ceph_tpu_torch [seed]
    JAX_PLATFORMS=cpu python tests/torch_f4_probe.py ceph_tpu [seed]

(from the repo root).  It wraps, on the package's classes, ``rb_capture``
(which early return it took: none, an absent shard, a store read that
raised, ``RB_MAX_CAPTURE``), ``roll_back_entry`` (its result, and on the
port whether the entry's write had stored nothing yet: ``unfanned``),
``_rb_trim_keys`` (the records trimmed), ``ECBackend.submit``,
``apply_sub_write_vec``, ``PG._commit_write`` and ``PG._note_entries``
(where each log entry came from), and prints one JSON object: the run's
outcome, the counts by kind, and for each rollback that returned False
what had happened to that (PG, version) by then.  Nothing in either
package changes.
"""

import collections
import importlib
import json
import os
import random
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch_daemon_harness as H  # noqa: E402


def main(pkg: str, seed: int) -> dict:
    B = importlib.import_module(pkg + ".osd.backend")
    PGm = importlib.import_module(pkg + ".osd.pg")
    GH = importlib.import_module(pkg + ".store.objectstore").GHObject
    counts = collections.Counter()
    cap, trims, fails = {}, set(), []
    events = collections.defaultdict(list)

    def ev(pg, v, what):
        events[(str(pg), str(v))].append(what)

    o_cap = B.ECBackend.rb_capture

    def rb_capture(self, txn, oid, shard, kind, off, length, version):
        g = GH(oid, shard=shard)
        why = "absent"
        if self.store.exists(self.coll, g):
            why = "recorded"
            try:
                data = self.store.read(self.coll, g)
                self.store.getattrs(self.coll, g)
                n = (len(data[off:off + length]) if kind == B.RB_EXTENT
                     else len(data))
                if n > B.RB_MAX_CAPTURE:
                    why = "max_capture"
            except Exception:  # noqa: BLE001 — the early return it models
                why = "read_raised"
        cap[(self.whoami, str(self.pgid), str(version), shard)] = why
        counts["capture_" + why] += 1
        return o_cap(self, txn, oid, shard, kind, off, length, version)

    o_rb = B.ECBackend.roll_back_entry

    def roll_back_entry(self, entry, meta_omap=None):
        # the port's backend knows the entries whose write stored
        # nothing yet (its fan-out not past the log fence)
        unfanned = getattr(self, "_unfanned", {}).get(id(entry)) is entry
        ok = o_rb(self, entry, meta_omap)
        counts["rollback_" + ("unfanned" if unfanned and ok else
                              "restored" if ok else "no_record")] += 1
        if not ok:
            v, pg = str(entry.version), str(self.pgid)
            fails.append({
                "osd": self.whoami, "pg": pg, "version": v,
                "oid": entry.oid, "op": entry.op,
                "captured_by_then": {f"osd.{o}.{s}": w for (o, p, vv, s), w
                                     in cap.items() if p == pg and vv == v},
                "trimmed": any(t[:2] == (self.whoami, pg) for t in trims),
                "events": list(events.get((pg, v), []))})
        return ok

    o_trim = B.ECBackend._rb_trim_keys

    def _rb_trim_keys(self, log_rm):
        for key in log_rm:
            trims.add((self.whoami, str(self.pgid), key))
        return o_trim(self, log_rm)

    o_sub = B.ECBackend.submit

    def submit(self, oid, state, entries, *a, **kw):
        if entries:
            ev(self.pgid, entries[-1].version, f"submit@osd.{self.whoami}")
        return o_sub(self, oid, state, entries, *a, **kw)

    o_vec = B.ECBackend.apply_sub_write_vec

    def apply_sub_write_vec(self, msg, on_commit=None):
        if msg.entries:
            ev(self.pgid, msg.entries[-1].version,
               f"sub_write_vec@osd.{self.whoami} rb={msg.rb}")
        return o_vec(self, msg, on_commit)

    o_cw = PGm.PG._commit_write

    def _commit_write(self, msg, *a, **kw):
        out = o_cw(self, msg, *a, **kw)
        ev(self.pgid, self.log.head, f"minted@osd.{self.osd.whoami}")
        return out

    o_ne = PGm.PG._note_entries

    def _note_entries(self, entries):
        for en in entries:
            ev(self.pgid, en.version, f"noted@osd.{self.osd.whoami}")
        return o_ne(self, entries)

    B.ECBackend.rb_capture = rb_capture
    B.ECBackend.roll_back_entry = roll_back_entry
    B.ECBackend._rb_trim_keys = _rb_trim_keys
    B.ECBackend.submit = submit
    B.ECBackend.apply_sub_write_vec = apply_sub_write_vec
    PGm.PG._commit_write = _commit_write
    PGm.PG._note_entries = _note_entries

    model = importlib.import_module(
        "test_torch_rados_model" if pkg == "ceph_tpu_torch"
        else "tests.test_rados_model")
    c = H.DaemonCluster(pkg)
    cl = H.LibClient(c)
    stop = threading.Event()

    def thrasher():
        rng = random.Random(seed ^ 3)
        while not stop.is_set():
            victim = rng.randrange(H.N_OSDS)
            try:
                c.kill(victim)
                time.sleep(rng.uniform(0.4, 0.9))
                c.revive(victim)
                time.sleep(rng.uniform(0.6, 1.2))
            except Exception:  # noqa: BLE001 — as the reference's thrasher
                pass

    th = threading.Thread(target=thrasher, daemon=True)
    th.start()
    t0 = time.time()
    try:
        ops = model._run_model_sequence(cl.rc.ioctx(H.EC_POOL),
                                        random.Random(seed), rounds=150,
                                        oid_space=16)
        outcome = f"passed, {sum(ops.values())} ops"
    except BaseException as e:  # noqa: BLE001 — the outcome is the report
        outcome = f"failed: {type(e).__name__}: {str(e)[:300]}"
    finally:
        stop.set()
        th.join(timeout=10)
        cl.shutdown()
        c.shutdown()
    return {"pkg": pkg, "seed": seed, "outcome": outcome,
            "seconds": round(time.time() - t0, 1), "counts": dict(counts),
            "no_record_rollbacks": fails}


if __name__ == "__main__":
    pkg = sys.argv[1] if len(sys.argv) > 1 else "ceph_tpu_torch"
    seed = int(sys.argv[2], 0) if len(sys.argv) > 2 else 0x1EC
    print(json.dumps(main(pkg, seed), indent=1, default=str))
