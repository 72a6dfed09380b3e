"""The port's bench loops and generator (ceph_tpu_torch.ops.benchloop,
ceph_tpu_torch.ops.mix32) held bit for bit against the reference package
(ceph_tpu.ops.benchloop, ceph_tpu.ops.mix32), the runners fed the Pallas
engines in interpret mode; and the port's EC engine bench
(ceph_tpu_torch.tools.ecbench) run on the CPU at small sizes, its oracle
held against ceph_tpu._native.rs_encode.

Tolerance: none, every word and every digest equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import _native
from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu.ops import benchloop as ref_loop
from ceph_tpu.ops import gf256_pallas, mix32
from ceph_tpu_torch.ops import benchloop, gf256_planes
from ceph_tpu_torch.ops import mix32 as port_mix
from ceph_tpu_torch.tools import ecbench

K, M = 8, 4
T = 8
TILE = 4
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF,
                  0x9E3779B9], dtype=np.uint32)


def _ids():
    rng = np.random.default_rng(0)
    return np.concatenate([EDGES, np.arange(5000, dtype=np.uint32),
                           rng.integers(0, 1 << 32, 5000,
                                        dtype=np.uint64).astype(np.uint32)])


def test_mix_np_is_the_reference_copy():
    i = _ids()
    assert np.array_equal(port_mix.mix_np(i), mix32.mix_np(i))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_mix_torch_equals_mix_np_and_mix_jnp(dtype):
    i = _ids()
    src = torch.from_numpy(i.astype(np.int64))
    if dtype == torch.int32:
        src = torch.from_numpy(i.view(np.int32).copy())  # u32 bit patterns
    got = port_mix.mix_torch(src)
    assert got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, mix32.mix_np(i))
    assert np.array_equal(got, np.asarray(mix32.mix_jnp(jnp.asarray(i))))


@pytest.mark.parametrize("k", [8, 3])
@pytest.mark.parametrize("interleaved", [False, True])
def test_gen_planes_equals_reference(k, interleaved):
    want = np.asarray(ref_loop.gen_planes(k, T, interleaved))
    got = benchloop.gen_planes(k, T, interleaved, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_gen_planes_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchloop.gen_planes(K, T)


def _engines(interleaved):
    coding = ref_matrices.isa_cauchy(K, M)
    if interleaved:
        def ref(w, s):
            return gf256_pallas.encode_planes_interleaved(
                coding, w, s, tile=TILE, interpret=True)
        port = ecbench.inter_engine(coding, TILE)
    else:
        def ref(w, s):
            return gf256_pallas.encode_planes(coding, w, s, tile=TILE,
                                              interpret=True)
        port = ecbench.planar_engine(coding, TILE)
    return ref, port


@pytest.mark.parametrize("interleaved", [False, True])
def test_sum_digest_runner_equals_reference(interleaved):
    ref, port = _engines(interleaved)
    want = int(ref_loop.sum_digest_runner(ref, 3)(
        ref_loop.gen_planes(K, T, interleaved)))
    run = benchloop.sum_digest_runner(port, 3)
    w3 = benchloop.gen_planes(K, T, interleaved, device="cpu")
    assert run(w3) == want
    assert run.seconds > 0
    assert run(w3) == want  # a second call digests afresh


@pytest.mark.parametrize("interleaved", [False, True])
def test_seeded_loop_runner_equals_reference(interleaved):
    ref, port = _engines(interleaved)
    shape = (T, M, 128) if interleaved else (M, T, 128)
    want = int(ref_loop.seeded_loop_runner(ref, shape, 3)(
        ref_loop.gen_planes(K, T, interleaved)))
    run = benchloop.seeded_loop_runner(port, shape, 3)
    assert run(benchloop.gen_planes(K, T, interleaved, device="cpu")) \
        == want & 0xFFFFFFFF
    bad = benchloop.seeded_loop_runner(port, (M, T, 64), 3)
    with pytest.raises(ValueError, match="engine output"):
        bad(benchloop.gen_planes(K, T, interleaved, device="cpu"))


def test_digest_is_the_low_byte_of_each_word():
    words = torch.tensor([0x000001FF, -1, 0x12345678],
                         dtype=torch.int32).reshape(1, 1, 3)
    run = benchloop.sum_digest_runner(lambda w, s, out=None: w, 2)
    assert run(words) == 2 * (0xFF + 0xFF + 0x78)


def _fake_cost(per_iter, fixed=0.0):
    """make_run whose calls 'take' fixed + iters * per_iter seconds: an
    injected clock; returns the calls made."""
    calls = []

    def make_run(iters):
        def call():
            calls.append(iters)
            return fixed + iters * per_iter
        return call
    return make_run, calls


def _reference_calibration(monkeypatch, per_iter, fixed=0.0, **kw):
    """The reference calibrate_loop under the same injected clock."""
    now = [0.0]
    monkeypatch.setattr(ref_loop.time, "perf_counter", lambda: now[0])

    def make_run(iters):
        def call():
            now[0] += fixed + iters * per_iter
        return call
    return ref_loop.calibrate_loop(make_run, **kw)


@pytest.mark.parametrize("per_iter,fixed,kw", [
    (1e-6, 0.0, {"start_iters": 16, "target_s": 1.5, "cap_s": 25.0}),
    (1e-3, 0.0, {"start_iters": 64, "target_s": 0.1, "cap_s": 2.0}),
    (2e-7, 5e-5, {"start_iters": 4, "target_s": 0.05, "cap_s": 0.5}),
    (1.3e-2, 0.0, {"start_iters": 1, "target_s": 2.0, "cap_s": 3.0}),
    (1e-6, 0.0, {"start_iters": 16, "target_s": 1.0, "cap_s": 25.0,
                 "max_iters": 4096}),
])
def test_calibrate_loop_grows_as_the_reference(monkeypatch, per_iter, fixed,
                                               kw):
    make_run, calls = _fake_cost(per_iter, fixed)
    iters, dt = benchloop.calibrate_loop(make_run, **kw)
    ref_iters, ref_dt = _reference_calibration(monkeypatch, per_iter, fixed,
                                               **kw)
    assert iters == ref_iters and dt == pytest.approx(ref_dt, rel=1e-9)
    # every iteration count is called twice (build + warm, then timed)
    assert calls[::2] == calls[1::2] and calls[-1] == iters
    assert all(n * per_iter <= max(kw["cap_s"], kw["start_iters"] * per_iter)
               * 1.0001 for n in calls)
    max_iters = kw.get("max_iters", 1 << 20)
    assert iters <= max_iters
    assert iters == max_iters or dt >= min(kw["target_s"], kw["cap_s"])


def test_calibrate_loop_stops_where_the_cap_leaves_no_room():
    """A target past the cap is cut to the cap; where the cap-projected
    count then falls just short of it, the count cannot grow, and the
    loop returns instead of calling the same count forever (as the
    reference does: it is not run here)."""
    make_run, calls = _fake_cost(1.1e-2)
    iters, dt = benchloop.calibrate_loop(make_run, start_iters=1,
                                         target_s=9.0, cap_s=3.0)
    assert iters == int(3.0 / 1.1e-2) and dt < 3.0
    assert max(calls) * 1.1e-2 <= 3.0
    assert calls == [1, 1, 272, 272]  # each count called twice


def test_calibrated_rate_and_loop_rate_on_the_cpu():
    coding = ref_matrices.isa_cauchy(K, M)
    w3 = benchloop.gen_planes(K, T, device="cpu")
    size = K * T * 512
    gbps, iters, dt = benchloop.calibrated_rate(
        ecbench.planar_engine(coding, TILE), w3, size, start_iters=1,
        target_s=0.005, cap_s=0.05, max_iters=8)
    assert gbps > 0 and 1 <= iters <= 8 and dt > 0
    assert gbps == pytest.approx(size * iters / dt / 1e9)
    assert benchloop.loop_rate_gbps(ecbench.planar_engine(coding, TILE), w3,
                                    (M, T, 128), 2, size) > 0
    assert benchloop.loop_mode("cpu") == "eager"
    assert benchloop.loop_mode("cuda") == "cuda_graph"


def test_ecbench_oracle_equals_native_rs_encode():
    coding = ref_matrices.isa_cauchy(K, M).astype(np.uint8)
    x = ecbench._host_planes(16)
    assert np.array_equal(ecbench.oracle_encode(coding, x),
                          _native.rs_encode(coding, x))
    rng = np.random.default_rng(2)
    y = rng.integers(0, 256, (K, 3000), dtype=np.uint8)
    assert np.array_equal(ecbench.oracle_encode(coding, y),
                          _native.rs_encode(coding, y))
    # the host mirror is the device generator's bytes
    assert np.array_equal(x, gf256_planes.unpack_planes(
        benchloop.gen_planes(K, 16, device="cpu")).numpy())


SMALL = dict(sweep=((16, 1), (32, 1)), tiles=(4, 8), pin_T=16, tune_T=32,
             target_s=0.002, cap_s=0.05, max_iters=8, start_iters=1,
             small_objs=64, small_min_T=8, envelope_bytes=1 << 16,
             matmul_n=32)


@pytest.fixture(scope="module")
def bench():
    return ecbench.run("cpu", **SMALL)


def test_ecbench_names_its_device(bench):
    assert bench["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert bench["timing"] == "eager" and "card" not in bench
    assert bench["encode_hbm_frac"] == ecbench.NOT_MEASURED


def test_ecbench_pins_hold(bench):
    assert bench["ec_device_pinned"] == {"planar": True, "inter": True}
    assert bench["ec_decode_pinned"] is True


def test_ecbench_tunes_every_variant(bench):
    tune = bench["ec_engine_tune_gbps"]
    names = {f"{lay}_t{t}{s}" for lay in ("planar", "inter")
             for t in (4, 8) for s in ("", "_shift")}
    assert set(tune) == names | {"xla_swar"}
    assert tune["xla_swar"].startswith("not on the card")
    assert all(isinstance(tune[n], float) and tune[n] > 0 for n in names)
    assert bench["ec_engine"] in names
    assert set(bench["ec_engine_by_layout"]) == {"planar", "inter"}


def test_ecbench_sweeps_both_layouts(bench):
    sweep = bench["ec_sweep"]
    assert sorted(int(s) for s in sweep) == [K * 16 * 512, K * 32 * 512]
    for row in sweep.values():
        assert set(row["layouts"]) == {"planar", "inter"}
        for cell in row["layouts"].values():
            for key in ("encode_gbps", "decode_gbps"):
                assert isinstance(cell[key], float) and cell[key] > 0
        assert row["suspect"] == ecbench.NOT_MEASURED
    assert bench["encode_gbps"] == sweep[str(K * 16 * 512)]["encode_gbps"]


def test_ecbench_small_stripes(bench):
    assert bench["small_stripe_4k_queue_machinery_gbps"] > 0
    assert bench["small_stripe_4k_batched_gbps"] > 0
    assert bench["small_stripe_stats"]["jobs"] == 2 * 64
    assert bench["small_stripe_host_path"] is False
    shapes = bench["small_stripe_device_rate_per_batch_shape"]
    assert shapes and all(v > 0 for v in shapes.values())


def test_ecbench_envelope_names_what_it_did_not_measure(bench):
    env = bench["envelope"]
    assert env["device"] == "cpu"
    assert env["chained_elementwise_gbps"] > 0
    assert env["h2d_1mib_pinned_mbps"] == ecbench.NOT_MEASURED
    assert env["matmul_bf16_tflops"] > 0


def test_ecbench_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ecbench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        ecbench.run()
