"""The fused sampler's base-noise stream in plain torch ops
(dpfx_torch.ops.fused_sampler.philox_noise_plain): Philox4x32-10 against
Random123's published known-answer vectors and a pure-Python integer run,
the stream keyed by (seed, cloud, point) so that a prefix of the points
draws the same noise, and the moments of N(0, scale^2). On the card the
kernel's noise is held to this stream (tests/test_torch_cuda.py,
chip_smoke.py)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dpfx_torch.models  # noqa: E402,F401  (the ops import the models first)
from dpfx_torch.ops import fused_sampler as fs  # noqa: E402

# Random123's kat_vectors for philox4x32 with 10 rounds: counter, key, output
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


def philox_int(c, k0, k1):
    """Philox4x32-10 on Python integers (exact, unbounded)."""
    c = list(c)
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
    return tuple(c)


@pytest.mark.parametrize("ctr,key,out", KAT)
def test_philox_known_answers(ctr, key, out):
    got = fs._philox(tuple(torch.tensor([v], dtype=torch.int64) for v in ctr), *key)
    assert tuple(int(v) for v in got) == out
    assert philox_int(ctr, *key) == out


def test_noise_words_match_integer_philox():
    """The int64 tensor rounds equal Python's exact integers on a spread of
    counters, and Box-Muller in f32 follows the kernel's formula."""
    seed = 0x1234_5678_9ABC_DEF0
    k0, k1 = seed & 0xFFFFFFFF, seed >> 32
    u = fs.philox_noise_plain(seed, 5, 77, 1.3)
    for b, p in ((0, 0), (4, 76), (2, 31), (3, 50)):
        w0 = philox_int((p, b, 0, 0), k0, k1)
        w1 = philox_int((p, b, 1, 0), k0, k1)
        for c, (a, bb) in enumerate(((w0[0], w0[1]), (w0[2], w0[3]), (w1[0], w1[1]))):
            u1 = np.float32(np.float32(a >> 8) * np.float32(2.0**-24) + np.float32(1e-7))
            u2 = np.float32(np.float32(bb >> 8) * np.float32(2.0**-24))
            ref = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * float(u2)) * 1.3
            assert abs(float(u[b, p, c]) - ref) <= 1e-5 * max(1.0, abs(ref))


def test_noise_is_keyed_by_seed_cloud_and_point():
    u = fs.philox_noise_plain(7, 4, 3000, 1.1)
    assert u.shape == (4, 3000, 3) and u.dtype == torch.float32
    # a prefix of the points, and of the clouds, draws the same noise
    assert torch.equal(fs.philox_noise_plain(7, 4, 1000, 1.1), u[:, :1000])
    assert torch.equal(fs.philox_noise_plain(7, 2, 3000, 1.1), u[:2])
    # another seed draws other noise; the high word of the seed counts
    assert not torch.equal(fs.philox_noise_plain(8, 4, 3000, 1.1), u)
    assert not torch.equal(fs.philox_noise_plain(7 + 2**32, 4, 3000, 1.1), u)
    # the scale multiplies the same stream
    torch.testing.assert_close(fs.philox_noise_plain(7, 4, 3000, 1.0) * 1.1, u, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("scale", [1.0, 0.8])
def test_noise_moments(scale):
    """120k draws: the standard errors are 0.003 (mean) and 0.004 (var)."""
    u = fs.philox_noise_plain(123, 8, 5000, scale).double() / scale
    assert abs(float(u.mean())) < 0.015
    assert abs(float(u.var()) - 1.0) < 0.02
    assert abs(float((u**4).mean()) - 3.0) < 0.1      # Gaussian kurtosis
    # the three coordinates are uncorrelated
    c = torch.corrcoef(u.reshape(-1, 3).t())
    assert float((c - torch.eye(3, dtype=c.dtype)).abs().max()) < 0.015
