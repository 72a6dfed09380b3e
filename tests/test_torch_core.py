"""The port's core host layer (``ceph_tpu_torch/core``), case for case
against ``tests/test_core.py``: encoding, crc, config, perf, throttle,
work queue, heartbeat, context + admin socket, log, lru.

``test_core.py``'s last case, ``test_osd_bench_admin_command``, needs
the OSD daemon and waits for slice 1i.  The bit-for-bit cross-checks
against ``ceph_tpu.core`` are in ``test_torch_core_xcheck.py``.
"""

import io
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.core import crc
from ceph_tpu_torch.core.admin_socket import admin_command
from ceph_tpu_torch.core.config import SCHEMA, Config
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.core.encoding import Decoder, DecodeError, Encoder
from ceph_tpu_torch.core.heartbeat import HeartbeatMap
from ceph_tpu_torch.core.log import Log
from ceph_tpu_torch.core.lru import LRUCache
from ceph_tpu_torch.core.perf import PerfCounters
from ceph_tpu_torch.core.throttle import Throttle
from ceph_tpu_torch.core.workqueue import ShardedWorkQueue


# -- encoding ---------------------------------------------------------------


def test_encoding_primitives_roundtrip():
    e = Encoder()
    e.u8(7).u16(300).u32(1 << 30).u64(1 << 50).s32(-5).s64(-(1 << 40))
    e.f64(3.25).boolean(True).string("héllo").blob(b"\x00\xff")
    e.seq([1, 2, 3], lambda enc, v: enc.u32(v))
    e.mapping({"b": 2, "a": 1}, lambda enc, k: enc.string(k),
              lambda enc, v: enc.u32(v))
    e.optional(None, lambda enc, v: enc.u32(v))
    e.optional(9, lambda enc, v: enc.u32(v))
    d = Decoder(e.bytes())
    assert d.u8() == 7
    assert d.u16() == 300
    assert d.u32() == 1 << 30
    assert d.u64() == 1 << 50
    assert d.s32() == -5
    assert d.s64() == -(1 << 40)
    assert d.f64() == 3.25
    assert d.boolean() is True
    assert d.string() == "héllo"
    assert d.blob() == b"\x00\xff"
    assert d.seq(lambda dec: dec.u32()) == [1, 2, 3]
    assert d.mapping(lambda dec: dec.string(), lambda dec: dec.u32()) == {
        "a": 1, "b": 2,
    }
    assert d.optional(lambda dec: dec.u32()) is None
    assert d.optional(lambda dec: dec.u32()) == 9


def test_encoding_version_skew_forward_compat():
    # a v2 encoder writes an extra field; a v1-era decoder must skip it
    e = Encoder()
    e.start(version=2, compat=1)
    e.u32(42).string("v2-only-extra")
    e.finish()
    e.u32(0xDEAD)  # trailing sibling field

    d = Decoder(e.bytes())
    v = d.start(compat_supported=1)
    assert v == 2
    assert d.u32() == 42
    d.end()  # skips the unknown string
    assert d.u32() == 0xDEAD


def test_encoding_compat_rejects_too_new():
    e = Encoder()
    e.start(version=5, compat=4)
    e.u32(1)
    e.finish()
    d = Decoder(e.bytes())
    with pytest.raises(DecodeError):
        d.start(compat_supported=3)


def test_decode_underrun_raises():
    with pytest.raises(DecodeError):
        Decoder(b"\x01").u32()


# -- crc32c -----------------------------------------------------------------


def test_crc32c_known_vectors():
    # standard castagnoli check value
    assert crc.crc32c(b"123456789") == 0xE3069283
    assert crc.crc32c(b"") == 0
    # chaining == one-shot
    whole = crc.crc32c(b"foobar")
    part = crc.crc32c(b"bar", crc.crc32c(b"foo"))
    assert whole == part


def test_crc32c_vectorised_matches_bytewise():
    # the counterpart of test_crc32c_native_matches_python: the fast
    # route against the byte loop, on both sides of the small-buffer
    # threshold
    data = np.random.default_rng(1000).integers(
        0, 256, 4 * crc.SMALL, dtype=np.uint8).tobytes()
    for n in (1000, crc.SMALL - 1, crc.SMALL, len(data)):
        assert crc.crc32c(data[:n]) == crc.crc32c_bytewise(data[:n]), n


# -- config -----------------------------------------------------------------


def test_config_defaults_and_set():
    c = Config()
    assert c.get("osd_pool_default_size") == 3
    c.set_val("osd_pool_default_size", "5")
    assert c.osd_pool_default_size == 5
    with pytest.raises(ValueError):
        c.set_val("objectstore", "not-a-backend")
    with pytest.raises(KeyError):
        c.set_val("no_such_option", 1)


def test_config_observer_fires_on_apply():
    c = Config()
    seen = []
    c.add_observer(("osd_heartbeat_grace",), lambda n, v: seen.append((n, v)))
    c.set_val("osd_heartbeat_grace", 33.0)
    assert seen == [("osd_heartbeat_grace", 33.0)]


def test_config_argv_and_diff():
    c = Config()
    rest = c.parse_argv(["--conf-mon-lease=9.5", "positional",
                         "--conf-log-level", "4"])
    assert rest == ["positional"]
    assert c.get("mon_lease") == 9.5
    d = c.diff()
    assert d["mon_lease"] == 9.5 and d["log_level"] == 4
    assert "osd_pool_default_size" not in d


def test_config_schema_types_validate_defaults():
    for name, opt in SCHEMA.items():
        opt.validate(opt.default)


# -- perf counters ----------------------------------------------------------


def test_perf_counters_dump():
    pc = PerfCounters("osd")
    pc.add_u64_counter("op_w")
    pc.add_u64_gauge("numpg")
    pc.add_time_avg("op_w_latency")
    pc.add_histogram("op_size")
    pc.inc("op_w", 3)
    pc.set("numpg", 8)
    pc.tinc("op_w_latency", 0.5)
    pc.tinc("op_w_latency", 1.5)
    pc.hinc("op_size", 4096)
    d = pc.dump()
    assert d["op_w"] == 3 and d["numpg"] == 8
    assert d["op_w_latency"]["avgcount"] == 2
    assert d["op_w_latency"]["avgtime"] == 1.0
    assert d["op_size"]["count"] == 1
    assert sum(d["op_size"]["buckets"]) == 1


# -- throttle ---------------------------------------------------------------


def test_throttle_blocks_until_put():
    t = Throttle("test", 10)
    assert t.get(8)
    assert not t.get_or_fail(5)
    released = []

    def waiter():
        t.get(5)
        released.append(True)

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    assert not released
    t.put(8)
    th.join(timeout=2)
    assert released
    t.put(5)
    # oversized single request passes an empty throttle
    assert t.get(100, timeout=1)


# -- sharded work queue -----------------------------------------------------


def test_sharded_wq_orders_per_token():
    wq = ShardedWorkQueue("t", 4, process=lambda item: item())
    wq.start()
    results = {i: [] for i in range(8)}

    def make(tok, i):
        def run():
            time.sleep(0.001)
            results[tok].append(i)
        return run

    for i in range(20):
        for tok in range(8):
            wq.queue(tok, make(tok, i))
    assert wq.drain(timeout=10)
    wq.stop()
    for tok in range(8):
        assert results[tok] == list(range(20))


def test_sharded_wq_priority():
    order = []
    claimed = threading.Event()
    gate = threading.Event()

    def process(item):
        if item == "blocker":
            claimed.set()
            gate.wait(5)
        else:
            order.append(item)

    wq = ShardedWorkQueue("t", 1, process=process)
    wq.start()
    wq.queue("x", "blocker", priority=63)
    assert claimed.wait(5)  # worker is busy; the rest queue up behind it
    wq.queue("x", "low", priority=1)
    wq.queue("x", "high", priority=63)
    wq.queue("x", "mid", priority=10)
    gate.set()
    assert wq.drain(timeout=5)
    wq.stop()
    assert order == ["high", "mid", "low"]


# -- heartbeat map ----------------------------------------------------------


def test_heartbeat_map_flags_stalled_worker():
    suicides = []
    hm = HeartbeatMap(on_suicide=suicides.append)
    h = hm.add_worker("w", grace=0.05, suicide_grace=0.1)
    assert hm.is_healthy()
    time.sleep(0.12)
    assert "w" in hm.unhealthy_workers()
    assert suicides == ["w"]
    h.touch()
    assert hm.is_healthy()


# -- context + admin socket -------------------------------------------------


def test_context_admin_socket(tmp_path):
    sock = str(tmp_path / "asok")
    ctx = Context("osd.0", {"admin_socket": sock})
    try:
        pc = ctx.perf.create("osd")
        pc.add_u64_counter("ops")
        pc.inc("ops", 5)
        out = admin_command(sock, "perf dump")
        assert out["osd"]["ops"] == 5
        admin_command(sock, "config set", key="mon_lease", value=7.0)
        out = admin_command(sock, "config get", key="mon_lease")
        assert out["mon_lease"] == 7.0
        assert "config diff" in admin_command(sock, "help")
        ctx.log.log("osd", 1, "hello-admin")
        assert any("hello-admin" in line
                   for line in admin_command(sock, "log dump"))
        assert admin_command(sock, "health")["healthy"]
    finally:
        ctx.shutdown()


def test_log_ring_and_crash_dump():
    log = Log(default_level=1, ring_size=10, name="osd.1",
              stream=io.StringIO())
    for i in range(20):
        log.log("osd", 10, f"quiet-{i}")  # gathered, not emitted
    recent = log.dump_recent()
    assert len(recent) == 10 and "quiet-19" in recent[-1]
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        text = log.dump_on_crash(e)
    assert "boom" in text and "quiet-19" in text


def test_lru_cache_generation_refuses_stale_fills():
    c = LRUCache(capacity=2)
    gen = c.generation()
    assert c.put("a", 1, gen=gen)
    c.clear()  # wholesale invalidation bumps the generation
    assert not c.put("b", 2, gen=gen), "stale-generation fill must drop"
    assert "b" not in c
    assert c.put("b", 2, gen=c.generation())
    c.pop("nope")  # single-key invalidation also bumps
    assert not c.put("c", 3, gen=gen)
    # capacity eviction, LRU order
    g = c.generation()
    c.put("x", 1, gen=g)
    c.put("y", 2, gen=g)
    c.get("x")
    c.put("z", 3, gen=g)
    assert "y" not in c and "x" in c and "z" in c
