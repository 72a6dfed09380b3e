"""``tests/test_meshio.py`` mirrored on the port: ``gpu/meshio.py``'s
``MeshCompute`` on an 8-cell CPU mesh (``["cpu"] * 8``: dp 4 x
shard_par 2, the reference tests' grid) beside the reference's
``MeshCompute(jax.devices()[:8])`` over the conftest's 8 virtual CPU
devices.  Inputs come from numpy seeds; every result is held to the
reference's bit for bit (tolerance zero: the products are GF(2^8) and
the digest is exact integer arithmetic mod 2^32).

The port's own cases: ``encp`` through the mesh against the reference
queue's CRCs, grids of 1, 3, 6 and 8 cells, coding rows that are not a
multiple of shard_par (k=4 m=3), the queue's routing of the codecs
without ``mds_recovery`` (clay, jerasure cauchy_good, shec) away from the
mesh, the digest's plain version at pitched slices, and the refusals
(a mixed CPU/CUDA list, ``MeshCompute()`` without a card).
"""

import numpy as np
import pytest
import torch

import jax

from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ec.codec import RSMatrixCodec as RefRS
from ceph_tpu.ops import gf256_swar
from ceph_tpu.tpu.meshio import MeshCompute as RefMesh
from ceph_tpu.tpu.queue import StripeBatchQueue as RefQueue
from ceph_tpu_torch.ec import codec_from_profile, codec_from_reference
from ceph_tpu_torch.gpu import shapebucket
from ceph_tpu_torch.gpu.meshio import MeshCompute
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.ops import mesh_digest as md

K, M = 8, 4
SURVIVORS = [0, 1, 2, 3, 4, 5, 8, 9]  # lose data 6, 7 and coding 2, 3


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return RefMesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def mesh():
    return MeshCompute(["cpu"] * 8)


@pytest.fixture(scope="module")
def codecs():
    ref = RefRS(K, M, ref_matrices.isa_cauchy(K, M))
    port = codec_from_reference(K, M, np.asarray(ref.coding), {},
                                device="cpu")
    return port, ref


def _planes(rows, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(rows, n), dtype=np.uint8)


def _swar(matrix, x):
    return np.asarray(gf256_swar.gf_matmul_bytes(matrix, x))


def _survivor_planes(ref, x):
    coding = _swar(ref.coding, x)
    return coding, {s: (x[s] if s < K else coding[s - K])
                    for s in SURVIVORS}


def test_mesh_is_the_reference_grid(mesh, ref_mesh):
    assert (mesh.dp, mesh.shard_par) == (4, 2)
    assert ref_mesh.mesh.devices.shape == (mesh.dp, mesh.shard_par)
    assert [len(r) for r in mesh.grid] == [2] * 4


def test_encode_scatter_matches_single_device(mesh, ref_mesh, codecs):
    port, ref = codecs
    x = _planes(K, 8192, 0)
    cm = np.asarray(ref.coding, np.uint8)
    got = mesh.encode_scatter(cm, x)
    assert isinstance(got, np.ndarray) and got.shape == (M, 8192)
    assert np.array_equal(got, ref_mesh.encode_scatter(cm, x))
    assert np.array_equal(got, _swar(ref.coding, x))


@pytest.mark.parametrize("n", [37, 1000, 8191])
def test_encode_scatter_ragged_width(mesh, ref_mesh, codecs, n):
    """Widths that do not divide the mesh pad internally and slice back."""
    _port, ref = codecs
    x = _planes(K, n, 1 + n)
    cm = np.asarray(ref.coding, np.uint8)
    got = mesh.encode_scatter(cm, x)
    assert got.shape == (M, n)
    assert np.array_equal(got, ref_mesh.encode_scatter(cm, x))
    assert np.array_equal(got, _swar(ref.coding, x))


def test_recovery_gather_rebuilds_data(mesh, ref_mesh, codecs):
    port, ref = codecs
    x = _planes(K, 4096, 2)
    _coding, avail = _survivor_planes(ref, x)
    rec, _ = port.recovery_matrix(SURVIVORS)
    ref_rec, _ = ref.recovery_matrix(SURVIVORS)
    assert np.array_equal(np.asarray(rec, np.uint8),
                          np.asarray(ref_rec, np.uint8))
    surv = np.stack([avail[s] for s in SURVIVORS])
    rebuilt = mesh.recovery_gather(np.asarray(rec, np.uint8), surv)
    assert np.array_equal(rebuilt, x)
    assert np.array_equal(rebuilt, ref_mesh.recovery_gather(
        np.asarray(ref_rec, np.uint8), surv))


def test_scrub_digest_mesh_invariant(mesh, ref_mesh):
    """The digest equals the reference's, does not depend on how the
    columns shard, and detects corruption."""
    p = _planes(K, 4096, 3)
    d8 = mesh.scrub_digest(p)
    assert isinstance(d8, int) and 0 <= d8 < 1 << 32
    assert d8 == ref_mesh.scrub_digest(p)
    solo = MeshCompute(["cpu"])
    assert solo.scrub_digest(p) == d8
    assert RefMesh(devices=[jax.devices()[0]]).scrub_digest(p) == d8
    p2 = p.copy()
    p2[3, 1000] ^= 0xFF
    d2 = mesh.scrub_digest(p2)
    assert d2 != d8 and d2 == ref_mesh.scrub_digest(p2)


def test_stripe_batch_queue_rides_the_mesh(mesh, ref_mesh, codecs):
    port, ref = codecs
    objs = [_planes(K, 512, 400 + i) for i in range(64)]
    q = StripeBatchQueue(device="cpu", mesh=mesh, window_s=0.005)
    rq = RefQueue(mesh=ref_mesh, window_s=0.005)
    try:
        futs = [q.encode_async(port, o) for o in objs]
        rfuts = [rq.encode_async(ref, o) for o in objs]
        for o, f, rf in zip(objs, futs, rfuts):
            got = np.asarray(f.result())
            assert np.array_equal(got, _swar(ref.coding, o))
            assert np.array_equal(got, np.asarray(rf.result()))
    finally:
        q.stop()
        rq.stop()
    assert q.jobs == 64
    assert q.mesh_batches >= 1, "coalesced batches must ride the mesh"
    assert q.mesh_batches == q.batches


def test_single_device_mesh_degenerates(codecs):
    _port, ref = codecs
    solo = MeshCompute(devices=["cpu"])
    assert (solo.dp, solo.shard_par) == (1, 1)
    x = _planes(K, 256, 5)
    cm = np.asarray(ref.coding, np.uint8)
    got = solo.encode_scatter(cm, x)
    assert np.array_equal(got, _swar(ref.coding, x))
    assert np.array_equal(got, RefMesh(
        devices=[jax.devices()[0]]).encode_scatter(cm, x))


def test_decode_batching_matches_and_coalesces(codecs):
    """decode_data_async: same-signature degraded reads coalesce into
    one recovery product and return exact data planes."""
    port, ref = codecs
    q = StripeBatchQueue(device="cpu", window_s=0.005)
    rq = RefQueue(window_s=0.005)
    objs = [_planes(K, 256, 600 + i) for i in range(32)]
    futs = []
    try:
        for x in objs:
            _coding, avail = _survivor_planes(ref, x)
            futs.append((x, q.decode_data_async(port, avail),
                         rq.decode_data_async(ref, dict(avail))))
        for x, f, rf in futs:
            got = np.asarray(f.result())
            assert np.array_equal(got, x)
            assert np.array_equal(got, np.asarray(rf.result()))
    finally:
        q.stop()
        rq.stop()
    assert q.jobs == 32
    assert q.batches < 32, "same-signature decodes must coalesce"
    assert q.mesh_batches == 0


def test_decode_batching_rides_mesh(mesh, ref_mesh, codecs):
    port, ref = codecs
    x = _planes(K, 512, 7)
    _coding, avail = _survivor_planes(ref, x)
    q = StripeBatchQueue(device="cpu", mesh=mesh, window_s=0.005)
    rq = RefQueue(mesh=ref_mesh, window_s=0.005)
    try:
        futs = [q.decode_data_async(port, dict(avail)) for _ in range(8)]
        rfuts = [rq.decode_data_async(ref, dict(avail)) for _ in range(8)]
        for f, rf in zip(futs, rfuts):
            got = np.asarray(f.result())
            assert np.array_equal(got, x)
            assert np.array_equal(got, np.asarray(rf.result()))
    finally:
        q.stop()
        rq.stop()
    assert q.mesh_batches >= 1 and q.mesh_batches == q.batches
    assert rq.mesh_batches >= 1


def test_device_resident_chain_no_host_hop(mesh, ref_mesh, codecs):
    """encode_scatter(keep_device=True) -> recovery_gather(tensor
    input): the chain stays in tensors; only the final fetch leaves."""
    import jax.numpy as jnp

    port, ref = codecs
    x = _planes(K, 4096, 5)
    xd = torch.from_numpy(x)
    cm = np.asarray(ref.coding, np.uint8)
    coding_dev = mesh.encode_scatter(cm, xd, keep_device=True)
    assert isinstance(coding_dev, torch.Tensor)
    assert coding_dev.device == xd.device and coding_dev.shape == (M, 4096)
    rec, _ = port.recovery_matrix(SURVIVORS)
    # survivors 8, 9 are coding rows 0, 1
    surv_dev = torch.cat([xd[:6], coding_dev[:2]])
    rebuilt = mesh.recovery_gather(np.asarray(rec, np.uint8), surv_dev,
                                   keep_device=True)
    assert isinstance(rebuilt, torch.Tensor)
    assert np.array_equal(rebuilt.numpy(), x)

    xj = jnp.asarray(x)
    ref_coding = ref_mesh.encode_scatter(cm, xj, keep_device=True)
    assert np.array_equal(coding_dev.numpy(), np.asarray(ref_coding))
    ref_rebuilt = ref_mesh.recovery_gather(
        np.asarray(rec, np.uint8),
        jnp.concatenate([xj[:6], ref_coding[:2]], axis=0),
        keep_device=True)
    assert np.array_equal(rebuilt.numpy(), np.asarray(ref_rebuilt))


def test_keep_device_of_a_numpy_input_lies_on_the_first_cell(mesh, codecs):
    _port, ref = codecs
    x = _planes(K, 1000, 8)
    got = mesh.encode_scatter(np.asarray(ref.coding, np.uint8), x,
                              keep_device=True)
    assert isinstance(got, torch.Tensor)
    assert got.device == mesh.grid[0][0] and got.shape == (M, 1000)
    assert np.array_equal(got.numpy(), _swar(ref.coding, x))


# -- the port's own cases ----------------------------------------------------

def test_encp_rides_the_mesh_with_the_reference_crcs(mesh, ref_mesh,
                                                     codecs):
    """Fused encode + CRC through the mesh: the coding and the per-shard
    CRC-32C of each job equal the reference queue's with its mesh, in
    coalesced batches of unequal widths."""
    port, ref = codecs
    widths = [512, 1000, 37, 4096, 256, 777, 2048, 64]
    objs = [_planes(K, w, 700 + i) for i, w in enumerate(widths)]
    q = StripeBatchQueue(device="cpu", mesh=mesh, window_s=0.005)
    rq = RefQueue(mesh=ref_mesh, window_s=0.005)
    try:
        futs = [q.encode_crc_async(port, o) for o in objs]
        rfuts = [rq.encode_crc_async(ref, o) for o in objs]
        for o, f, rf in zip(objs, futs, rfuts):
            coding, crcs = f.result()
            rcoding, rcrcs = rf.result()
            assert np.array_equal(np.asarray(coding), _swar(ref.coding, o))
            assert np.array_equal(np.asarray(coding), np.asarray(rcoding))
            assert np.array_equal(np.asarray(crcs, np.uint32),
                                  np.asarray(rcrcs, np.uint32))
    finally:
        q.stop()
        rq.stop()
    assert q.jobs == len(objs)
    assert q.mesh_batches == q.batches >= 1
    assert q.batches < len(objs), "the encp jobs must coalesce"


@pytest.mark.parametrize("cells", [1, 3, 6, 8])
def test_grids_match_the_reference(codecs, cells):
    """Every grid the factorization gives (1 x 1, 3 x 1, 3 x 2, 4 x 2):
    encode, recovery and digest equal the reference's mesh of the same
    device count, at a width no grid divides."""
    port, ref = codecs
    pm = MeshCompute(["cpu"] * cells)
    rm = RefMesh(jax.devices()[:cells])
    assert (pm.dp, pm.shard_par) == rm.mesh.devices.shape
    x = _planes(K, 3001, 800 + cells)
    cm = np.asarray(ref.coding, np.uint8)
    coding = pm.encode_scatter(cm, x)
    assert np.array_equal(coding, rm.encode_scatter(cm, x))
    assert np.array_equal(coding, _swar(ref.coding, x))
    rec = np.asarray(port.recovery_matrix(SURVIVORS)[0], np.uint8)
    surv = np.stack([x[s] if s < K else coding[s - K] for s in SURVIVORS])
    rebuilt = pm.recovery_gather(rec, surv)
    assert np.array_equal(rebuilt, x)
    assert np.array_equal(rebuilt, rm.recovery_gather(rec, surv))
    shards = np.vstack([x, coding])
    assert pm.scrub_digest(shards) == rm.scrub_digest(shards)


def test_rows_not_a_multiple_of_shard_par(mesh):
    """k=4 m=3 on the 4 x 2 grid: 3 coding rows and a 3-row decode do
    not split over two shard cells, so every cell computes all rows (as
    the reference does) and the bytes are the reference's."""
    ref = RefRS(4, 3, ref_matrices.isa_cauchy(4, 3))
    port = codec_from_reference(4, 3, np.asarray(ref.coding), {},
                                device="cpu")
    rm = RefMesh(jax.devices()[:8])
    x = _planes(4, 5000, 9)
    cm = np.asarray(ref.coding, np.uint8)
    coding = mesh.encode_scatter(cm, x)
    assert np.array_equal(coding, rm.encode_scatter(cm, x))
    assert np.array_equal(coding, _swar(ref.coding, x))
    survivors = [3, 4, 5, 6]  # lose data 0, 1, 2
    rec = np.asarray(port.recovery_matrix(survivors)[0], np.uint8)[:3]
    surv = np.stack([x[3]] + [coding[i] for i in range(3)])
    rebuilt = mesh.recovery_gather(rec, surv)
    assert rebuilt.shape == (3, 5000)
    assert np.array_equal(rebuilt, x[:3])
    assert np.array_equal(rebuilt, rm.recovery_gather(rec, surv))


@pytest.mark.parametrize("profile", [
    "plugin=clay k=4 m=2",
    "plugin=jerasure k=4 m=2 technique=cauchy_good packetsize=32",
    "plugin=shec k=4 m=3 c=2",
])
def test_queue_keeps_codecs_without_mds_recovery_off_the_mesh(mesh,
                                                              profile):
    """The mesh route follows ``mds_recovery``: an array code (clay), a
    bit-matrix code and shec keep their own batches, leave mesh_batches
    at 0, and code exactly what the reference codec codes."""
    port = codec_from_profile(profile, device="cpu")
    ref = ref_codec_from_profile(profile)
    assert not getattr(port, "mds_recovery", False)
    k = port.k
    width = port.get_chunk_size(k * 4096)
    objs = [_planes(k, width, 900 + i) for i in range(6)]
    q = StripeBatchQueue(device="cpu", mesh=mesh, window_s=0.005)
    try:
        futs = [q.encode_crc_async(port, o) for o in objs]
        for o, f in zip(objs, futs):
            coding, _crcs = f.result()
            assert np.array_equal(np.asarray(coding),
                                  np.asarray(ref.encode_array(o)))
    finally:
        q.stop()
    assert q.jobs == len(objs) and q.batches >= 1
    assert q.mesh_batches == 0


def test_mixed_devices_refused():
    with pytest.raises(ValueError, match="one kind of device"):
        MeshCompute(["cpu", "cuda"])
    with pytest.raises(ValueError, match="one kind of device"):
        MeshCompute([torch.device("cuda", 0)] + ["cpu"] * 3)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshCompute()
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshCompute(["cuda"] * 8)


def test_shard_par_is_checked():
    with pytest.raises(ValueError, match="shard_par"):
        MeshCompute(["cpu"] * 2, shard_par=3)
    with pytest.raises(ValueError, match="at least one"):
        MeshCompute([])
    m = MeshCompute(["cpu"] * 7, shard_par=2)  # the odd cell is dropped
    assert (m.dp, m.shard_par, len(m.devices)) == (3, 2, 6)


def _ref_digest(p: np.ndarray) -> int:
    """scrub_digest's step (meshio.py:227-232) in numpy."""
    return int((p.astype(np.uint32) * np.uint32(2654435761)).sum(
        dtype=np.uint64)) & 0xFFFFFFFF


@pytest.mark.parametrize("n", [1, 3, 4095, 1 << 16])
def test_mesh_digest_plain_is_the_reference_formula(n):
    p = _planes(12, n + 7, 1000 + n)
    for x in (p[:, :n], p[:, 5:5 + n], p[3:4, 7:7 + n]):
        got = md.mesh_digest(torch.from_numpy(x))
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == _ref_digest(x)
        assert torch.equal(got, md.mesh_digest_plain(torch.from_numpy(x)))


def test_mesh_digest_writes_its_out_scratch():
    x = torch.from_numpy(_planes(4, 100, 11))
    out = torch.full((2,), -1, dtype=torch.int64)
    got = md.mesh_digest(x, out=out)
    assert int(got) == int(out[0]) == _ref_digest(x.numpy())
    with pytest.raises(ValueError, match="int64"):
        md.mesh_digest(x, out=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        md.mesh_digest(x.to(torch.int32))


def test_the_meshio_family_is_declared():
    spec = shapebucket.get_spec("meshio")
    assert spec is not None and "4*dp" in spec.note
    assert shapebucket.covering(3001, 4 * 4) == 16 * 256


def test_mesh_phase_code_on_the_cpu():
    """chip_smoke's ``main`` and ``mesh`` phases at four 1 MiB objects on
    the CPU: every batch rides the 4 x 2 mesh, the CRCs and coding equal
    main's, the digests equal the plain version's and a one-cell mesh's,
    and the chain is exact (the launch checks hold on the card only)."""
    import chip_smoke

    lines = []
    dev = torch.device("cpu")
    main = chip_smoke.phase_main(torch, dev, lines.append, nobj=4,
                                 obj_bytes=1 << 20)
    res = chip_smoke.phase_mesh(torch, dev, lines.append, main, nobj=4,
                                obj_bytes=1 << 20)
    assert res["batches"]["write"][1] == res["batches"]["write"][0] >= 1
    assert res["batches"]["read"][1] == res["batches"]["read"][0] >= 1
    assert np.array_equal(res["crcs"], main["crcs"])
    assert res["digest_shape"] == [K + M, (1 << 20) // K]
    assert lines[-1].startswith("mesh: MeshCompute([cpu] * 8), 4 x 2")
