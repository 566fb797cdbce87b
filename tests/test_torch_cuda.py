"""The fused sampler kernel against its plain version on the card, at small
shapes. Marked ``gpu``: each test skips without a CUDA device. On a
machine with one:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

(``--noconftest``: the suite's conftest sets JAX up, and the port needs no JAX.)
"""

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.compat import randomize_  # noqa: E402
from dpfx_torch.models import CouplingFlow  # noqa: E402
from dpfx_torch.ops import fused_sampler as fs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sp(hidden, n_hidden, activation, dev, k=6, seed=0):
    flow = CouplingFlow(3, k, hidden, n_hidden, cond_dim=16, scale_cap=3.0, activation=activation)
    return fs.stack_point_flow_params(randomize_(flow, seed, 0.1).to(dev))


@pytest.mark.parametrize("hidden,n_hidden,activation,n", [
    (32, 2, "relu", 200), (64, 1, "gelu", 128), (128, 3, "tanh", 300), (256, 2, "leaky_relu", 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_inverse_matches_plain(cuda, hidden, n_hidden, activation, n, dtype):
    dt = getattr(torch, dtype)
    if fs.smem_bytes(hidden, dt) > fs.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared"):
            fs._check_kernel_args(_sp(hidden, n_hidden, activation, cuda),
                                  torch.zeros(1, 6, hidden, device=cuda), dt, activation)
        return
    sp = _sp(hidden, n_hidden, activation, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    ut = torch.randn((3, 8, n), generator=g, device=cuda)
    z = torch.randn((3, 16), generator=g, device=cuda)
    fs.reset_launch_counts()
    x = fs.fused_inverse_transposed(sp, ut, z, dtype=dt, activation=activation)
    ref = fs.fused_inverse_transposed_plain(sp, ut, fs.z_projection(sp, z), dt, activation)
    torch.cuda.synchronize()
    assert fs.launches["fused_inverse"] == 1
    # f32: both sides sum in IEEE f32 in other orders; bf16: a flipped
    # rounding of one hidden unit moves a coordinate by ~1e-3
    tol = 1e-4 if dt == torch.float32 else 5e-2
    torch.testing.assert_close(x, ref, atol=tol, rtol=tol)
    torch.testing.assert_close(x[:, 3:], ut[:, 3:], atol=0, rtol=0)


def test_smem_mirror_matches_kernel(cuda):
    """The wrapper's shared-memory check mirrors the kernel's carve-up."""
    lib = fs._lib()
    for h in fs.KERNEL_HIDDEN:
        for dt, bf16 in ((torch.float32, 0), (torch.bfloat16, 1)):
            assert fs.smem_bytes(h, dt) == lib.dpfx_fused_sampler_smem_bytes(h, bf16)


def test_fused_sample_draws_then_inverts(cuda):
    sp = _sp(64, 2, "relu", cuda)
    z = torch.randn((4, 16), device=cuda)
    x, u = fs.fused_sample_points(sp, z, 7, 3000, dtype=torch.float32, noise_scale=1.1,
                                  return_noise=True)
    ref = fs.fused_point_flow_inverse(sp, u, z, dtype=torch.float32)
    torch.testing.assert_close(x, ref, atol=1e-4, rtol=1e-4)
    assert abs(float(u.mean())) < 0.03 and abs(float(u.var()) / 1.21 - 1) < 0.05
    torch.testing.assert_close(fs.fused_sample_points(sp, z, 7, 3000, dtype=torch.float32,
                                                      noise_scale=1.1), x, atol=0, rtol=0)
    # the stream is keyed by (seed, cloud, point): a prefix draws the same noise
    _, u_head = fs.fused_sample_points(sp, z, 7, 1000, dtype=torch.float32, noise_scale=1.1,
                                       return_noise=True)
    torch.testing.assert_close(u_head, u[:, :1000], atol=0, rtol=0)
