"""The port on the card: the CUDA K5 gather against its plain version, and
the forward through it against the CPU's. Marked ``gpu``; they skip where
there is no card. This file imports no JAX, so it runs on a machine without
it: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from kmunet_tpu_torch import serve
from kmunet_tpu_torch.kernels import bilinear
# By its own name (pytest puts tests/ on sys.path): tests/ has no __init__.py,
# so an installed regular package named ``tests`` would shadow ``tests.*``.
from torch_cases import GATHER_CASES, GATHER_SHAPES, cuda_device, gather_inputs  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_cuda_kernel_matches_plain(cuda_device, mode, shape, case, dtype):
    """fp32 within 1e-5 abs of the plain version; bf16 within one bf16 ulp
    of the kernel's fp32 result on the same rounded image."""
    img, x, y = gather_inputs(GATHER_SHAPES[shape], case)
    img_t = torch.from_numpy(img).to(cuda_device, dtype)
    x_t, y_t = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
    before = bilinear.bilinear_gather.launches
    got = bilinear.bilinear_gather(img_t, x_t, y_t, mode).float()
    torch.cuda.synchronize()
    assert bilinear.bilinear_gather.launches == before + 1
    if dtype == torch.float32:
        want = bilinear.bilinear_gather_plain(img_t, x_t, y_t, mode)
        tol = torch.full_like(want, 1e-5)
    else:
        want = bilinear.bilinear_gather(img_t.float(), x_t, y_t, mode)
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    assert bool(((got - want).abs() <= tol).all())


def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    img = torch.zeros(1, 4, 4, 8, device=cuda_device)
    x = torch.zeros(1, 2, 2, device=cuda_device)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather(img.double(), x, x)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather(img, x.half(), x.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(img.permute(0, 2, 1, 3), x, x)
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(img, x.cpu(), x.cpu())


def test_cuda_forward_matches_cpu_plain_path(cuda_device, monkeypatch):
    """The card's forward, through the CUDA gather, against the CPU's, with
    TF32 off; 9 gather launches (DAGEM's deformable conv) per forward."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model_cpu = serve.build_km_unet_v3_sh(device="cpu", seed=2)
    model_gpu = serve.build_km_unet_v3_sh(device=cuda_device, seed=2)
    frames = np.random.default_rng(2).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    before = bilinear.bilinear_gather.launches
    got = serve.predict(model_gpu, frames).cpu().numpy()
    assert bilinear.bilinear_gather.launches == before + 9
    want = serve.predict(model_cpu, frames).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
