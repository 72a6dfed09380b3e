"""The port's core layer bit for bit against ``ceph_tpu.core``: the host
CRC-32C, the encoder's bytes, the config schema, and the routes that
wait for later slices (the standalone mclock scheduler)."""

import numpy as np
import pytest

from ceph_tpu.core import config as ref_config
from ceph_tpu.core import crc as ref_crc
from ceph_tpu.core import encoding as ref_enc
from ceph_tpu.core import workqueue as ref_wq
from ceph_tpu_torch.core import config, crc, encoding, workqueue

# -- the host CRC-32C -------------------------------------------------------

_RNG = np.random.default_rng(20261017)
_BUF = _RNG.integers(0, 256, (1 << 16) + 64, dtype=np.uint8)


@pytest.mark.parametrize("lo", range(0, 1025, 128))
def test_crc_every_length_to_1024(lo):
    for n in range(lo, min(lo + 128, 1025)):
        d = _BUF[:n].tobytes()
        assert crc.crc32c(d) == ref_crc.crc32c(d), n


@pytest.mark.parametrize("off", [1, 3, 5, 7, 13, 4093])
def test_crc_odd_offsets_into_a_larger_buffer(off):
    """Views that start off any word boundary, as numpy arrays, bytes,
    memoryviews and bytearrays, over lengths around the small-buffer
    threshold and the segment sizes."""
    for n in (1, 4, 7, 8, 9, 63, 64, 65, crc.SMALL - 1, crc.SMALL,
              crc.SMALL + 1, 4099, 65537 - off):
        view = _BUF[off:off + n]
        want = ref_crc.crc32c(view)
        assert crc.crc32c(view) == want, (off, n)
        assert crc.crc32c(view.tobytes()) == want
        assert crc.crc32c(memoryview(_BUF)[off:off + n]) == want
        assert crc.crc32c(bytearray(view.tobytes())) == want


def test_crc_chained_calls():
    d = _BUF.tobytes()
    inits = [0, 1, 0xFFFFFFFF, 0x80000000, 0x12345678]
    cuts = [0, 1, 3, 4, 7, 8, 511, 512, 4096, 40001, len(d)]
    for init in inits:
        whole = ref_crc.crc32c(d, init)
        assert crc.crc32c(d, init) == whole
        for a, b in zip(cuts, cuts[1:]):
            first = crc.crc32c(d[:b], init)
            assert crc.crc32c(d[b:], first) == whole, (init, b)
        c = init
        for a, b in zip(cuts, cuts[1:]):
            c = crc.crc32c(d[a:b], c)
        assert c == whole


def test_crc_4mib_and_the_byte_loop():
    big = np.random.default_rng(4).integers(0, 256, 4 << 20, dtype=np.uint8)
    assert crc.crc32c(big) == ref_crc.crc32c(big)
    assert crc.crc32c(big[5:], 0xDEADBEEF) == \
        ref_crc.crc32c(big[5:], 0xDEADBEEF)
    small = big[:3000]
    assert crc.crc32c_bytewise(small, 77) == ref_crc.crc32c(small, 77)


def test_crc_non_contiguous_and_multibyte_arrays():
    m = _BUF[:4096].reshape(64, 64)
    cols = m[:, ::2]                       # a non-contiguous view
    assert crc.crc32c(cols) == ref_crc.crc32c(np.ascontiguousarray(cols))
    words = _BUF[:4096].view(np.uint32)     # a buffer of wider items
    assert crc.crc32c(words) == ref_crc.crc32c(words)
    assert crc.crc32c(memoryview(cols)) == \
        ref_crc.crc32c(np.ascontiguousarray(cols))


# -- the encoder --------------------------------------------------------------


def _corpus(mod, seed):
    """One encoding of every primitive, container and envelope, over
    seeded values, through mod's Encoder."""
    rng = np.random.default_rng(seed)
    e = mod.Encoder()
    ints = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, 24)]
    for v in ints:
        e.u8(v).u16(v).u32(v).u64(v)
        e.s32(v % (1 << 31) - (1 << 30)).s64(v)
        e.f64(v / 7.0).boolean(v & 1)
    blob = rng.integers(0, 256, int(rng.integers(0, 300)),
                        dtype=np.uint8).tobytes()
    e.blob(blob).blob(bytearray(blob)).blob(memoryview(blob))
    e.string("".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 40)))
    e.raw(bytes(range(17)))
    e.seq(ints, lambda enc, v: enc.s64(v))
    e.mapping({f"k{int(v) % 97}": v for v in ints},
              lambda enc, k: enc.string(k), lambda enc, v: enc.s64(v))
    e.optional(None, lambda enc, v: enc.u32(v))
    e.optional(ints[0] & 0xFFFF, lambda enc, v: enc.u32(v))
    # nested versioned envelopes with a forward-compat tail
    e.start(3, 2)
    e.u32(ints[1] & 0xFFFFFFFF)
    e.start(1, 1).string("inner").finish()
    e.blob(blob[:33])
    e.finish()
    e.start(255, 0).finish()           # an empty envelope
    return e.bytes()


def _decode(mod, blob):
    """_corpus read back through mod's Decoder, field for field."""
    d = mod.Decoder(blob)
    out = []
    for _ in range(24):
        out += [d.u8(), d.u16(), d.u32(), d.u64(), d.s32(), d.s64(),
                d.f64(), d.boolean()]
    out += [d.blob(), d.blob(), bytes(d.blob_view()), d.string(),
            d.raw(17)]
    ints = d.seq(lambda dec: dec.s64())
    out += [ints, d.mapping(lambda dec: dec.string(),
                            lambda dec: dec.s64()),
            d.optional(lambda dec: dec.u32()),
            d.optional(lambda dec: dec.u32())]
    out.append(d.start(3))
    out.append(d.u32())
    d.end()  # skips the inner envelope and the blob
    out += [d.start(0), d.remaining_in_frame()]
    d.end()
    out.append(d.off == len(blob))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_encoder_bytes_equal_the_reference(seed):
    got = _corpus(encoding, seed)
    assert got == _corpus(ref_enc, seed)
    # and the two decoders read it back alike
    assert _decode(encoding, got) == _decode(ref_enc, got)


def test_decoder_envelopes_equal_the_reference():
    """A v3 frame with an unknown tail, a too-new frame and an underrun
    decode (or fail) identically in both packages."""
    def frames(mod):
        e = mod.Encoder()
        e.start(3, 1).u32(5).string("tail-a-v1-reader-skips").finish()
        e.u16(0xBEEF)
        e.start(9, 7).u8(1).finish()
        return e.bytes()

    blob = frames(encoding)
    assert blob == frames(ref_enc)
    out = []
    for mod in (encoding, ref_enc):
        d = mod.Decoder(blob)
        v = d.start(1)
        first = d.u32()
        left = d.remaining_in_frame()
        d.end()
        tail = d.u16()
        with pytest.raises(mod.DecodeError):
            d.start(2)
        with pytest.raises(mod.DecodeError):
            mod.Decoder(blob[:3]).u32()
        out.append((v, first, left, tail))
    assert out == [(3, 5, 26, 0xBEEF)] * 2


# -- the config schema --------------------------------------------------------


def test_schema_equals_the_reference():
    """Same option names in the same order, with the same type, default,
    level, bounds, enum and runtime flag: a conf that parses on one
    package parses on the other."""
    def rows(schema):
        return [(o.name, o.type, o.default, o.level, o.minval, o.maxval,
                 tuple(o.enum) if o.enum else None, o.runtime)
                for o in schema.values()]

    assert rows(config.SCHEMA) == rows(ref_config.SCHEMA)


def test_xla_only_options_say_what_the_port_lacks():
    for name, item in (("tpu_compile_cache_dir", "item 4"),
                       ("tpu_recompile_storm_window", "item 4"),
                       ("tpu_recompile_storm_min_sigs", "item 4"),
                       ("tpu_recompile_storm_min_rogue_sigs", "item 4"),
                       ("tpu_warmup_budget_s", "slice 1i"),
                       ("tpu_boot_warmup", "slice 1i"),
                       ("erasure_code_tile_n", "item 4")):
        desc = config.SCHEMA[name].desc
        assert "port" in desc and item in desc, (name, desc)


def test_config_parses_a_conf_like_the_reference():
    argv = ["--conf-mon-lease=9.5", "x", "--conf-osd-op-queue", "fifo",
            "--conf-tpu-boot-warmup=on", "--conf-erasure-code-tile-n",
            "4096", "--conf-ms-crc-data=false"]
    mine, ref = config.Config(), ref_config.Config()
    assert mine.parse_argv(argv) == ref.parse_argv(argv) == ["x"]
    assert mine.dump() == ref.dump()
    assert mine.diff() == ref.diff()
    for bad in (("objectstore", "nope"), ("ms_crc_data", "maybe")):
        with pytest.raises(ValueError):
            config.Config().set_val(*bad)
        with pytest.raises(ValueError):
            ref_config.Config().set_val(*bad)


# -- routes that wait for later slices ----------------------------------------


def test_mclock_scheduler_waits_for_the_daemon_slice():
    """The standalone mclock scheduler reaches osd.mclock: the reference
    builds one, the port names slice 1i; fifo and a caller's qos work."""
    ref = ref_wq.ShardedWorkQueue("r", 1, process=lambda i: None,
                                  scheduler="mclock")
    assert ref._mclock is not None
    with pytest.raises(NotImplementedError, match="slice 1i"):
        workqueue.ShardedWorkQueue("p", 1, process=lambda i: None,
                                   scheduler="mclock")

    class _Qos:
        def make_shard_queue(self):
            return "shard-queue"

    wq = workqueue.ShardedWorkQueue("p", 2, process=lambda i: None,
                                    scheduler="mclock", qos=_Qos())
    assert wq._mclock == ["shard-queue", "shard-queue"]
