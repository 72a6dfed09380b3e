"""The port's dencoder (``ceph_tpu_torch/tools/dencoder.py``) and the
committed corpus read in place, case for case against the OSD and
monitor cases of ``tests/test_dencoder.py`` (lines 16, 24, 33, 66, 104,
182, 218, 319, 336 and 379 there), plus the port's dencoder examples held
byte-equal to the reference tool's and every v1 message blob re-encoded
byte-equal by both packages.

Three cases of that file wait for the EC backend and the PG (ROADMAP
queue 1 item 1f), which apply or serve what these blobs carry:
``test_legacy_mec_sub_write_still_decodes_and_applies``,
``test_legacy_mec_sub_read_vec_serves_through`` and
``test_legacy_mec_sub_read_still_decodes_and_serves``; here their blobs
only decode.  The cephfs blobs of ``tests/corpus/`` (MClientCaps,
MClientReply, MClientRequest) wait for item 6 and are reported so.
"""

import binascii
import contextlib
import io
import os
import sys

import pytest

from ceph_tpu_torch.mon import messages as mm
from ceph_tpu_torch.msg import message as message_mod
from ceph_tpu_torch.msg.message import MSG_REGISTRY, Message
from ceph_tpu_torch.osd import messages as om
from ceph_tpu_torch.osd.types import EVersion
from ceph_tpu_torch.tools import dencoder

HERE = os.path.dirname(__file__)
CORPUS = os.path.join(HERE, "corpus")
V1_CORPUS = os.path.join(HERE, "corpus_v1")
V1_MESSAGES = ("MECSubReadVecReply_v1.hex", "MECSubReadVecReply_v2.hex",
               "MECSubReadVec_v1.hex", "MECSubReadVec_v2.hex",
               "MECSubRead_v1_serve.hex", "MECSubWriteVec_v1.hex",
               "MECSubWrite_v1.hex", "MECSubWrite_v2_apply.hex",
               "MScrubMap_v1.hex", "MScrub_v1.hex")


def _ref_dencoder():
    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "tools")))
    try:
        import dencoder as ref
    finally:
        sys.path.pop(0)
    return ref


def _run(main, argv) -> tuple:
    """(exit code, standard output) of a dencoder ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _v1_blob(name: str) -> bytes:
    with open(os.path.join(V1_CORPUS, name)) as f:
        return binascii.unhexlify(f.read().strip())


def test_roundtrip_all_message_types():
    for cls in MSG_REGISTRY.values():
        assert dencoder.roundtrip(cls)


def test_committed_corpus_still_decodes():
    assert os.path.isdir(CORPUS), "corpus missing"
    rc, out = _run(dencoder.main, ["corpus", "verify", CORPUS])
    assert rc == 0
    archived = {f[:-4] for f in os.listdir(CORPUS) if f.endswith(".bin")}
    for cls in MSG_REGISTRY.values():
        if cls.__name__ in archived:
            assert f"{cls.__name__}: decodes ok" in out
        else:  # newer than the corpus (the vec messages, the note ack)
            assert f"skip {cls.__name__}: no archived encoding" in out
    for name in ("struct_CrushMap", "struct_PGPool"):
        assert f"{name}: decodes ok" in out
    for name in ("MClientCaps", "MClientReply", "MClientRequest"):
        assert f"wait {name}: waits for ROADMAP queue 1 item 6" in out
        assert f"{name}: decodes ok" not in out
    assert "FAIL" not in out


def test_example_instances_cover_payloads():
    msg = dencoder._example(om.MOSDOp)
    assert msg.oid and msg.ops and msg.reqid
    back = Message.from_bytes(msg.to_bytes())
    assert back.oid == msg.oid and back.reqid == msg.reqid


# the types the port's modules define (other tests register their own)
PORT_NAMES = sorted(
    c.__name__ for mod in (message_mod, om, mm) for c in vars(mod).values()
    if isinstance(c, type) and issubclass(c, Message)
    and c.__module__ == mod.__name__ and c.TYPE)


@pytest.mark.parametrize("name", PORT_NAMES)
def test_examples_equal_the_reference_tool(name):
    """The port's example of each type encodes to the reference tool's
    bytes, and each decodes the other's."""
    ref = _ref_dencoder()
    port_blob = dencoder._example(dencoder._cls(name)).to_bytes()
    ref_blob = ref._example(ref._cls(name)).to_bytes()
    assert port_blob == ref_blob
    assert Message.from_bytes(ref_blob).to_bytes() == ref_blob


def test_generated_corpus_verifies_in_the_reference_tool(tmp_path):
    """``corpus generate`` of the port writes blobs (and the two structs)
    that the reference tool verifies, and the port verifies them too."""
    ref = _ref_dencoder()
    assert _run(dencoder.main, ["corpus", "generate", str(tmp_path)])[0] == 0
    for blob in tmp_path.iterdir():
        if blob.stem not in PORT_NAMES and not blob.stem.startswith(
                "struct_"):
            blob.unlink()
    assert len(list(tmp_path.iterdir())) == len(PORT_NAMES) + 2
    rc, out = _run(ref.main, ["corpus", "verify", str(tmp_path)])
    assert rc == 0 and "FAIL" not in out
    rc, out = _run(dencoder.main, ["corpus", "verify", str(tmp_path)])
    assert rc == 0 and "FAIL" not in out
    for name in ("struct_CrushMap", "struct_PGPool"):
        with open(tmp_path / f"{name}.bin", "rb") as f:
            assert f.read() == ref.STRUCTS[name][0]()


def test_encode_list_and_decode_commands(tmp_path):
    rc, out = _run(dencoder.main, ["list"])
    assert rc == 0 and out.split() == dencoder.type_names()
    assert "MECSubWriteVec" in out.split()
    rc, hexed = _run(dencoder.main, ["encode", "MPGQuery"])
    assert rc == 0
    path = tmp_path / "q.hex"
    path.write_text(hexed.strip())
    rc, out = _run(dencoder.main, ["decode", str(path)])
    assert rc == 0 and out.startswith("MPGQuery ")
    rc, out = _run(dencoder.main, ["roundtrip-all"])
    assert rc == 0 and "MECCommitNoteAck: ok" in out


@pytest.mark.parametrize("name", V1_MESSAGES)
def test_v1_blobs_reencode_alike_in_both_packages(name):
    from ceph_tpu.msg.message import Message as RefMessage
    import ceph_tpu.osd.messages  # noqa: F401 (registers the types)

    blob = _v1_blob(name)
    port, ref = Message.from_bytes(blob), RefMessage.from_bytes(blob)
    assert type(port).__name__ == type(ref).__name__
    assert port.struct_v == ref.struct_v
    assert port.to_bytes() == ref.to_bytes()


def test_v1_mec_sub_write_decodes_with_defaulted_tail():
    msg = Message.from_bytes(_v1_blob("MECSubWrite_v1.hex"))
    assert isinstance(msg, om.MECSubWrite)
    assert msg.pgid == (2, 5) and msg.epoch == 33
    assert msg.shard == 1 and msg.txn == b"\x01\x02\x03"
    assert len(msg.entries) == 1 and msg.entries[0].oid == "obj-a"
    assert msg.oid == "" and msg.rb_kind == 0
    assert msg.rb_off == 0 and msg.rb_len == 0
    assert msg.committed_to == EVersion()


def test_v1_mec_sub_write_vec_roundtrips_byte_stable():
    blob = _v1_blob("MECSubWriteVec_v1.hex")
    msg = Message.from_bytes(blob)
    assert isinstance(msg, om.MECSubWriteVec)
    assert msg.pgid == (2, 5) and msg.epoch == 33
    assert msg.oid == "obj-a"
    assert msg.rb == [(1, 1, 0, 0), (4, 1, 0, 0)]
    assert len(msg.entries) == 1 and msg.entries[0].oid == "obj-a"
    assert msg.committed_to == EVersion(4, 15)
    assert msg.to_bytes() == blob, "vec v1 re-encode is not byte-stable"


def test_v1_mec_sub_read_vec_decodes_with_defaulted_runs():
    blob = _v1_blob("MECSubReadVec_v1.hex")
    msg = Message.from_bytes(blob)
    assert isinstance(msg, om.MECSubReadVec)
    assert msg.pgid == (2, 5) and msg.epoch == 33
    assert msg.reads == [(1, "obj-a", 0, 0), (4, "obj-a", 0, 0),
                         (2, "obj-b", 4096, 1024)]
    assert msg.runs == [[], [], []]
    v2 = msg.to_bytes()
    back = Message.from_bytes(v2)
    assert back.reads == msg.reads and back.runs == msg.runs
    assert back.to_bytes() == v2

    rep = Message.from_bytes(_v1_blob("MECSubReadVecReply_v1.hex"))
    assert isinstance(rep, om.MECSubReadVecReply)
    assert len(rep.rows) == 2
    shard, oid, data, result, attrs, omap = rep.rows[0]
    assert (shard, oid, data, result) == (1, "obj-a", b"chunk-one", 0)
    assert omap == {"k1": b"v1"} and "hinfo" in attrs
    assert rep.rows[1][:4] == (4, "obj-a", b"", -5)  # EIO row
    assert rep.served == [0, 0]
    v2 = rep.to_bytes()
    back = Message.from_bytes(v2)
    assert back.rows == rep.rows and back.served == rep.served
    assert back.to_bytes() == v2


def test_v2_mec_sub_read_vec_golden_blobs_roundtrip():
    blob = _v1_blob("MECSubReadVec_v2.hex")
    msg = Message.from_bytes(blob)
    assert isinstance(msg, om.MECSubReadVec)
    assert msg.struct_v == 2
    assert msg.reads == [(1, "obj-a", 0, 0), (4, "obj-a", 0, 0)]
    assert msg.runs == [[(0, 4), (8, 4)], []]
    assert msg.to_bytes() == blob

    blob = _v1_blob("MECSubReadVecReply_v2.hex")
    rep = Message.from_bytes(blob)
    assert isinstance(rep, om.MECSubReadVecReply)
    assert rep.struct_v == 2 and len(rep.rows) == 2
    assert rep.rows[0][:4] == (1, "obj-a", b"layer-bytes", 0)
    assert rep.served == [1, 0]
    assert rep.to_bytes() == blob


def test_legacy_blobs_of_the_backend_cases_decode():
    """The blobs of the three cases that wait for 1f decode here with
    their fields; applying and serving them waits for the backend."""
    msg = Message.from_bytes(_v1_blob("MECSubWrite_v2_apply.hex"))
    assert isinstance(msg, om.MECSubWrite)
    assert msg.shard == 1 and msg.oid == "obj-a" and msg.rb_kind == 1
    assert msg.committed_to == EVersion(4, 15)
    from ceph_tpu_torch.store.objectstore import Transaction

    txn = Transaction.from_bytes(msg.txn)
    assert any(bytes(op.data) == b"legacy-chunk" for op in txn.ops)
    msg = Message.from_bytes(_v1_blob("MECSubRead_v1_serve.hex"))
    assert isinstance(msg, om.MECSubRead)
    assert msg.pgid == (2, 5) and msg.shard == 1 and msg.oid == "obj-a"


def test_v1_mscrub_decodes_deep_default():
    msg = Message.from_bytes(_v1_blob("MScrub_v1.hex"))
    assert isinstance(msg, om.MScrub)
    assert msg.pgid == (2, 5) and msg.epoch == 33 and msg.tid == 7
    assert msg.deep is True
    v2 = msg.to_bytes()
    back = Message.from_bytes(v2)
    assert back.deep is True and back.to_bytes() == v2


def test_v1_mscrubmap_decodes_with_defaulted_unreadable():
    msg = Message.from_bytes(_v1_blob("MScrubMap_v1.hex"))
    assert isinstance(msg, om.MScrubMap)
    assert msg.pgid == (2, 5) and msg.epoch == 33
    assert msg.digests == {"obj-a": 0x11223344, "obj-b": 0x55667788}
    assert msg.unreadable == []
    v2 = msg.to_bytes()
    back = Message.from_bytes(v2)
    assert back.digests == msg.digests and back.to_bytes() == v2


def test_v2_reencode_of_v1_payload_roundtrips():
    msg = Message.from_bytes(_v1_blob("MECSubWrite_v1.hex"))
    v2 = msg.to_bytes()
    back = Message.from_bytes(v2)
    assert back.to_bytes() == v2
    assert back.pgid == msg.pgid and back.txn == msg.txn
    assert back.committed_to == msg.committed_to
