"""The CUDA kernels against their plain versions on the card. Marked
``cuda``: they skip where there is no GPU (run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -o addopts="" --noconftest``,
since the JAX test conftest and the xdist options are not for that machine)."""

import pytest
import torch

from gluefactory_torch.ops import attention as A

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.float16, 2e-3),
                                        (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(1, 4, 512, 512), (2, 4, 100, 70)])
def test_kernels_match_plain(device, dtype, atol, shape):
    b, h, nq, nk = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, h, nq, 64, generator=g, device=device).to(dtype)
    k = torch.randn(b, h, nk, 64, generator=g, device=device).to(dtype)
    v = torch.randn(b, h, nk, 64, generator=g, device=device).to(dtype)
    mask = torch.rand(b, nk, generator=g, device=device) > 0.2
    if b > 1:
        mask[-1] = False  # a fully-masked batch item
    before = dict(A.launches)
    out = A.attention_cuda(q, k, v, mask)
    torch.testing.assert_close(out.float(), A.attention_plain(q, k, v, mask).float(),
                               atol=atol, rtol=atol)
    theta = torch.randn(b, nk, 32, generator=g, device=device)
    cos = theta.cos().repeat_interleave(2, -1).to(dtype)
    sin = theta.sin().repeat_interleave(2, -1).to(dtype)
    k, v = k[:, :, :nk], v[:, :, :nk]
    q = torch.randn(b, h, nk, 64, generator=g, device=device).to(dtype)
    out = A.attention_rotary_cuda(q, k, v, cos, sin, mask)
    torch.testing.assert_close(
        out.float(), A.attention_rotary_plain(q, k, v, cos, sin, mask).float(),
        atol=atol, rtol=atol)
    assert A.launches["attention"] == before["attention"] + 1
    assert A.launches["attention_rotary"] == before["attention_rotary"] + 1


def test_wrappers_raise_on_what_the_kernel_does_not_take(device):
    q = torch.randn(1, 4, 64, 64, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        A.attention_cuda(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        A.attention_cuda(q[..., :32].contiguous(), q[..., :32].contiguous(),
                         q[..., :32].contiguous())
    with pytest.raises(TypeError):
        A.attention_cuda(q.double(), q.double(), q.double())
