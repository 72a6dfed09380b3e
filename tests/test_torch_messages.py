"""The port's OSD and monitor messages (``ceph_tpu_torch/osd/messages.py``,
``ceph_tpu_torch/mon/messages.py``) against ``ceph_tpu``'s.

``test_roundtrip`` is ``tests/test_messages_roundtrip.py``'s test over
the port's registry: every scalar field mutated, the bytes decoded
through the registry and re-encoded identically.  ``test_bytes_equal
_the_reference`` gives the same mutation to a message of each package:
the bytes are equal and each package decodes the other's to the same
bytes and fields.  The richer cases fill the containers and the optional
tails (trace context, sub-chunk runs, served flags, incrementals).
"""

import numpy as np
import pytest

import ceph_tpu.mon.messages  # noqa: F401 (registers the reference's types)
import ceph_tpu.osd.messages  # noqa: F401
from ceph_tpu.msg.message import MSG_REGISTRY as REF_REGISTRY
from ceph_tpu.msg.message import EntityName as RefEntityName
from ceph_tpu.msg.message import Message as RefMessage
from ceph_tpu.osd import types as ref_types
from ceph_tpu_torch.mon import messages as mm
from ceph_tpu_torch.msg import message as message_mod
from ceph_tpu_torch.msg.message import MSG_REGISTRY, EntityName, Message
from ceph_tpu_torch.osd import messages as om
from ceph_tpu_torch.osd import types


def _defined_in(*modules) -> list:
    """(TYPE, class) of the message types the modules define: a fixed
    list whatever other tests register at run time."""
    return sorted((c.TYPE, c) for mod in modules for c in vars(mod).values()
                  if isinstance(c, type) and issubclass(c, Message)
                  and c.__module__ == mod.__name__ and c.TYPE)


PORT_TYPES = _defined_in(message_mod, om, mm)
SCALARS = (bool, int, float, str, bytes, tuple)


def _mutate(msg, EVersion, Entity) -> None:
    """Give every scalar field a non-default value so a dropped field
    changes the wire image (containers stay empty)."""
    for name, val in list(vars(msg).items()):
        if name == "src":
            msg.src = Entity("osd", 3)
        elif name == "pgid":
            msg.pgid = (5, 9)
        elif isinstance(val, bool):
            setattr(msg, name, True)
        elif isinstance(val, int):
            setattr(msg, name, 3)  # fits every u8/u32/s32/u64 field
        elif isinstance(val, float):
            setattr(msg, name, 2.5)
        elif isinstance(val, str):
            setattr(msg, name, "t")
        elif isinstance(val, bytes):
            setattr(msg, name, b"\x01\x02")
        elif isinstance(val, EVersion):
            setattr(msg, name, EVersion(2, 9))


def _ev(v) -> tuple:
    return (v.epoch, v.version)


def _plain(val):
    """A field as plain data, comparable across the two packages."""
    if hasattr(val, "epoch") and hasattr(val, "version"):
        return ("ev", _ev(val))
    if isinstance(val, memoryview):
        return bytes(val)
    if isinstance(val, (list, tuple)):
        return [_plain(v) for v in val]
    if isinstance(val, dict):
        return {k: _plain(v) for k, v in val.items()}
    if hasattr(val, "__dataclass_fields__") or hasattr(val, "kind"):
        return {k: _plain(v) for k, v in vars(val).items()}
    return val


def test_the_registry_holds_the_reference_types():
    assert len(PORT_TYPES) == 42  # 28 OSD, 12 monitor, MPing and MAck
    assert len(_defined_in(om)) == 28 and len(_defined_in(mm)) == 12
    for code, cls in PORT_TYPES:
        assert MSG_REGISTRY[code] is cls
        ref = REF_REGISTRY[code]
        assert ref.__name__ == cls.__name__
        assert (cls.TYPE, cls.VERSION, cls.COMPAT) == (
            ref.TYPE, ref.VERSION, ref.COMPAT)


@pytest.mark.parametrize("code,cls", PORT_TYPES,
                         ids=lambda v: getattr(v, "__name__", v))
def test_roundtrip(code, cls):
    msg = cls()
    _mutate(msg, types.EVersion, EntityName)
    wire = msg.to_bytes()
    back = Message.from_bytes(wire)
    assert type(back) is cls
    assert back.to_bytes() == wire
    for name, val in vars(msg).items():
        if isinstance(val, SCALARS + (types.EVersion,)):
            assert getattr(back, name) == val, f"{cls.__name__}.{name}"


@pytest.mark.parametrize("code,cls", PORT_TYPES,
                         ids=lambda v: getattr(v, "__name__", v))
def test_bytes_equal_the_reference(code, cls):
    port, ref = cls(), REF_REGISTRY[code]()
    _mutate(port, types.EVersion, EntityName)
    _mutate(ref, ref_types.EVersion, RefEntityName)
    wire = port.to_bytes()
    assert wire == ref.to_bytes()
    from_port = RefMessage.from_bytes(wire)
    from_ref = Message.from_bytes(ref.to_bytes())
    assert type(from_port) is type(ref) and type(from_ref) is cls
    assert from_port.to_bytes() == from_ref.to_bytes() == wire
    assert _plain(vars(from_ref)) == _plain(vars(from_port))


def _rich_pairs():
    """(port message, reference message) built alike with filled
    containers and tails."""
    rng = np.random.default_rng(16)
    payload = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()

    def entries(T):
        return [T.LogEntry(op=1, oid="obj-a", version=T.EVersion(7, 3),
                           prior_version=T.EVersion(7, 2), mtime=1.25,
                           payload=b"ec", reqid="client.4:9")]

    def build(M, T, mon):
        ops = [T.OSDOp(T.OP_WRITEFULL, off=0, length=len(payload),
                       data=payload, name="n", kv={"a": b"1"}, keys=["k"]),
               T.OSDOp(T.OP_READ, off=4, length=8)]
        op = M.MOSDOp((2, 5), 33, "obj-a", ops)
        op.reqid, op.snap_seq, op.snaps, op.snapid = "client.4:9", 4, [1, 3], 2
        op.set_trace((0xABCDEF, 0x1234))
        vec = M.MECSubWriteVec((2, 5), 33, "obj-a", payload[:64],
                               entries(T), rb=[(1, 1, 0, 0), (4, 2, 8, 16)],
                               committed_to=T.EVersion(7, 1))
        vec.set_trace((9, 10))
        sw = M.MECSubWrite((2, 5), 33, 2, payload[:16], entries(T),
                           oid="obj-a", rb_kind=2, rb_off=4, rb_len=8,
                           committed_to=T.EVersion(7, 2))
        rv = M.MECSubReadVec((2, 5), 33, [(1, "obj-a", 0, 0),
                                          (4, "obj-b", 4096, 1024)],
                             runs=[[(0, 4), (8, 4)], []])
        rv.set_trace((5, 6))
        rr = M.MECSubReadVecReply(
            (2, 5), 33, [(1, "obj-a", payload[:32], 0, {"crc": b"\1\2\3\4"},
                          {"k": b"v"}), (4, "obj-b", b"", -5, {}, {})],
            served=[1, 0])
        info = T.PGInfo(pgid=(2, 5), last_update=T.EVersion(7, 3),
                        committed_to=T.EVersion(7, 1))
        pi = M.MPGInfo((2, 5), 33, info, entries(T))
        push = M.MPGPush((2, 5), 33, "obj-a", T.EVersion(7, 3), payload,
                         {"a": b"1"}, {"o": b"2"}, shard=3, off=64,
                         total=1024, more=True)
        sm = M.MScrubMap((2, 5), 33, {"obj-a": 0x11223344}, ["obj-b"])
        cn = M.MECCommitNote((2, 5), 33, T.EVersion(7, 3))
        cn.set_trace((1, 2))
        ack = M.MECCommitNoteAck((2, 5), 33, T.EVersion(7, 3),
                                 T.EVersion(7, 4))
        stat = T.PGStat(pgid=(2, 5), state="active+clean", primary=True,
                        num_objects=4, last_update=T.EVersion(7, 3),
                        last_scrub=1.5, scrub_errors=1)
        st = mon.MPGStats(3, 33, [(2, 5, "active", 4, 7, 3, True)],
                          used_bytes=10, total_bytes=20, stats=[stat],
                          slow_ops=2, heartbeat_misses=5)
        mp = mon.MOSDMapMsg(33, payload[:50])
        mp.incs = [payload[50:60], payload[60:90]]
        paxos = mon.MMonPaxos(mon.MMonPaxos.BEGIN, 5, 9, b"value", 1, 8, 4,
                              9, b"uncommitted")
        cmd = mon.MMonCommand({"prefix": "osd tree", "epoch": 3})
        return [op, vec, sw, rv, rr, pi, push, sm, cn, ack, st, mp, paxos,
                cmd, M.MOSDOpReply((2, 5), 33, "obj-a", ops, -2,
                                   T.EVersion(7, 3))]

    import ceph_tpu.mon.messages as ref_mon
    import ceph_tpu.osd.messages as ref_om

    return list(zip(build(om, types, mm), build(ref_om, ref_types, ref_mon)))


@pytest.mark.parametrize("i", range(15))
def test_filled_messages_equal_the_reference(i):
    port, ref = _rich_pairs()[i]
    for mmsg, Entity in ((port, EntityName), (ref, RefEntityName)):
        mmsg.tid, mmsg.seq, mmsg.src = 77, 5, Entity("osd", 2)
    wire = port.to_bytes()
    assert wire == ref.to_bytes(), type(port).__name__
    from_port = RefMessage.from_bytes(wire)
    from_ref = Message.from_bytes(wire)
    assert from_port.to_bytes() == from_ref.to_bytes() == wire
    assert _plain(vars(from_ref)) == _plain(vars(from_port))
    assert from_ref.struct_v == from_port.struct_v == type(port).VERSION


def test_trace_tail_and_struct_v_tails_do_not_mix():
    """MECSubReadVec keys its runs on struct_v and still carries the bare
    trace tail; MECSubWrite keys its v2 tail on the frame remainder."""
    rv = om.MECSubReadVec((2, 5), 33, [(1, "o", 0, 0)], runs=[[(2, 3)]])
    rv.set_trace((11, 12))
    back = Message.from_bytes(rv.to_bytes())
    assert back.runs == [[(2, 3)]] and back.trace_ctx() == (11, 12)
    untraced = om.MECSubReadVec((2, 5), 33, [(1, "o", 0, 0)])
    back = Message.from_bytes(untraced.to_bytes())
    assert back.runs == [[]] and back.trace_ctx() is None
    sw = om.MECSubWrite((2, 5), 33, 1, b"t", oid="o", rb_kind=1)
    back = Message.from_bytes(sw.to_bytes())
    assert back.oid == "o" and back.rb_kind == 1


def test_osdmap_message_carries_the_port_maps_to_the_reference_and_back():
    """MOSDMapMsg with the port's ``map_codec`` bytes: a full map and a
    chain of two incrementals, encoded by the port, decode in
    ``ceph_tpu`` to maps that re-encode to the same bytes; the
    reference's message decodes in the port likewise."""
    from ceph_tpu.mon import messages as ref_mon
    from ceph_tpu.osd import map_codec as ref_codec
    from ceph_tpu.osd import map_inc as ref_inc
    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.osd import map_codec, map_inc
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool, POOL_REPLICATED

    cm, root = cmap.build_flat_cluster(32, hosts=8)
    cm.add_simple_rule("r", root, 1, mode="firstn")
    m = OSDMap(cm, max_osd=32, device="cpu")
    m.add_pool(PGPool(1, POOL_REPLICATED, size=3, min_size=2, pg_num=32,
                      pgp_num=32, crush_rule=0))
    e0 = map_inc.clone_map(m)
    m.set_osd_down(3)
    i1 = map_inc.diff_maps(e0, m)
    e1 = map_inc.clone_map(m)
    m.set_osd_out(3)
    m.reweight_osd(7, 0x2000)
    i2 = map_inc.diff_maps(e1, m)

    full = mm.MOSDMapMsg(e0.epoch, map_codec.encode_osdmap(e0))
    chain = mm.MOSDMapMsg(m.epoch, b"")
    chain.incs = [i1.encode(), i2.encode()]
    got_full = RefMessage.from_bytes(full.to_bytes())
    got_chain = RefMessage.from_bytes(chain.to_bytes())
    assert isinstance(got_full, ref_mon.MOSDMapMsg)
    ref_map = ref_codec.decode_osdmap(got_full.data)
    assert ref_codec.encode_osdmap(ref_map) == full.data
    for blob, want in zip(got_chain.incs, (e1, m)):
        ref_map = ref_inc.Incremental.decode(blob).apply(ref_map)
        assert ref_codec.encode_osdmap(ref_map) == \
            map_codec.encode_osdmap(want)

    back = ref_mon.MOSDMapMsg(ref_map.epoch,
                              ref_codec.encode_osdmap(ref_map))
    back.incs = list(got_chain.incs)
    port_msg = Message.from_bytes(back.to_bytes())
    assert isinstance(port_msg, mm.MOSDMapMsg)
    assert port_msg.to_bytes() == back.to_bytes()
    port_map = map_codec.decode_osdmap(port_msg.data, device="cpu")
    assert map_codec.encode_osdmap(port_map) == map_codec.encode_osdmap(m)
    applied = e0
    for blob in port_msg.incs:
        applied = map_inc.Incremental.decode(blob).apply(applied)
    assert map_codec.encode_osdmap(applied) == map_codec.encode_osdmap(m)
