"""The port's OSD core types (``ceph_tpu_torch/osd/types.py``) over the
committed v1 corpus: the three types-only cases of tests/test_dencoder.py
(``PGInfo``, ``LogEntry`` and ``PGStat`` v1 blobs decode with their v2
tails defaulted, and PGStat's v2 re-encode is byte-stable).  Byte
equality with ceph_tpu is held in tests/test_torch_osdmap_xcheck.py."""

import binascii
import os

V1_CORPUS = os.path.join(os.path.dirname(__file__), "corpus_v1")


def _v1_blob(name: str) -> bytes:
    with open(os.path.join(V1_CORPUS, name)) as f:
        return binascii.unhexlify(f.read().strip())


def test_v1_pg_info_decodes_with_defaulted_watermark():
    from ceph_tpu_torch.core.encoding import Decoder
    from ceph_tpu_torch.osd.types import EVersion, PGInfo

    info = PGInfo.decode(Decoder(_v1_blob("PGInfo_v1.hex")))
    assert info.pgid == (2, 5) and info.epoch_created == 7
    assert info.last_update == EVersion(4, 17)
    assert info.last_complete == EVersion(4, 15)
    assert info.committed_to == EVersion()  # v2 field, v1 blob


def test_v1_log_entry_decodes_with_empty_reqid():
    from ceph_tpu_torch.core.encoding import Decoder
    from ceph_tpu_torch.osd.types import EVersion, LogEntry

    en = LogEntry.decode(Decoder(_v1_blob("LogEntry_v1.hex")))
    assert en.op == 3 and en.oid == "deleted-obj"
    assert en.version == EVersion(6, 2)
    assert en.reqid == ""  # v2 field, v1 blob


def test_v1_pgstat_decodes_with_defaulted_scrub_tail():
    from ceph_tpu_torch.core.encoding import Decoder, Encoder
    from ceph_tpu_torch.osd.types import EVersion, PGStat

    s = PGStat.decode(Decoder(_v1_blob("PGStat_v1.hex")))
    assert s.pgid == (2, 5) and s.state == "active+degraded"
    assert s.primary and s.num_objects == 42 and s.degraded == 3
    assert s.last_update == EVersion(4, 99)
    assert s.cl_wr_bytes == 40960 and s.rec_ops == 2
    # v2 tail defaulted, not garbage-decoded
    assert s.last_scrub == 0.0 and s.last_deep_scrub == 0.0
    assert s.scrub_errors == 0
    e = Encoder()
    s.encode(e)
    v2 = e.bytes()
    back = PGStat.decode(Decoder(v2))
    e2 = Encoder()
    back.encode(e2)
    assert e2.bytes() == v2
    assert back.num_objects == 42 and back.scrub_errors == 0
