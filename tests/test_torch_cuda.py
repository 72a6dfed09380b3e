"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a CUDA device every test here skips
(the decision is taken inside the fixture, never at import).  Run them
on a GPU machine, where JAX (which tests/conftest.py imports) may be
absent, with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import codec_from_profile, matrices
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.ops import crc32c_device as cd
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.osd.ecutil import StripeInfo

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (3, 3)])
@pytest.mark.parametrize("n", [1, 1001, 4096, 1 << 20])
def test_gf256_kernel_equals_plain(dev, k, m, n):
    coding = matrices.isa_rs_vandermonde(k, m)
    g = torch.Generator(device=dev).manual_seed(k * n)
    x = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                      generator=g)
    before = gf256.launches.value
    got = gf256.gf_matmul_bytes(coding, x, seed=0x5A5A5A5A)
    assert gf256.launches.value == before + 1
    assert torch.equal(got, gf256.gf_matmul_bytes_plain(coding, x,
                                                        seed=0x5A5A5A5A))


def test_gf256_kernel_donates_in_place(dev):
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    rec, _ = codec.recovery_matrix([0, 1, 2, 3, 4, 5, 8, 9])
    x = torch.randint(0, 256, (8, 1 << 16), dtype=torch.uint8, device=dev)
    want = gf256.gf_matmul_bytes_plain(rec, x)
    got = gf256.gf_matmul_bytes(rec, x, donate=True)
    assert got.data_ptr() == x.data_ptr() and torch.equal(got, want)


def test_crc_kernel_equals_plain(dev):
    rows = torch.randint(0, 256, (513, 4099), dtype=torch.uint8, device=dev)
    lens = np.arange(0, 4097, 8)[:513] + np.arange(513) % 8
    lens = np.minimum(lens, 4096)
    inits = np.arange(513, dtype=np.uint32) * 2654435761
    for view in (rows[:, :4096], rows[:, 3:]):
        got = cd.crc32c_lanes(view, lens, inits)
        want = cd.crc32c_lanes_plain(view, lens, inits).cpu().numpy()
        assert np.array_equal(got, want.astype(np.uint32))
    full = rows[:12]
    got = cd.crc32c_rows(full, [0, 5, 2000], [5, 1995, 2099], [1, 2, 3])
    want = cd.crc32c_rows(full.cpu(), [0, 5, 2000], [5, 1995, 2099],
                          [1, 2, 3])
    assert np.array_equal(got, want)


def test_queue_write_and_degraded_read_on_the_card(dev):
    codec = codec_from_profile("plugin=isa k=8 m=4", device=dev)
    si = StripeInfo(8, 128 << 10)
    rng = np.random.default_rng(3)
    objs = [rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
            for _ in range(4)]
    q = StripeBatchQueue(device=dev)
    try:
        planes = [si.interleave(o)[0] for o in objs]
        res = [f.result(timeout=120) for f in
               [q.encode_crc_async(codec, p) for p in planes]]
        for p, (c, crcs) in zip(planes, res):
            assert np.array_equal(c, codec.encode_array(p))
            shards = torch.from_numpy(np.concatenate([p, c]))
            assert np.array_equal(crcs, cd.crc32c_lanes(
                shards.to(dev), np.full(12, p.shape[1])))
        for o, p, (c, _) in zip(objs, planes, res):
            avail = {s: p[s] if s < 8 else c[s - 8]
                     for s in (0, 1, 2, 3, 4, 5, 8, 9)}
            d = q.decode_data_async(codec, avail).result(timeout=120)
            assert si.deinterleave(d, len(o)) == o
    finally:
        q.stop()
