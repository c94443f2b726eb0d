"""The deformable conv's one multiview gather against the nine single
gathers and the concatenation it replaces, on the CPU in fp32.

``DeformConv2d`` samples its 3x3 taps as the views of one
``bilinear_gather_multiview`` call (K7 on the card, G = 9). Its forward must
equal nine ``bilinear_gather`` calls (their plain versions here) and
``torch.cat`` bit for bit, and its gradients to x, offset, weight and bias
must match the nine-call path within 1e-5 abs: d_x sums the nine taps'
terms in another order (over the views in fp32, where autograd added nine
gradients). JAX parity of the module is tests/test_torch_modules.py's and
tests/test_torch_train.py's.
"""

import numpy as np
import pytest
import torch

from kmunet_tpu_torch.kernels import bilinear
from kmunet_tpu_torch.nn import resample


def nine_gathers(module, x, offset):
    """The deformable conv as nine single gathers and a concatenation."""
    B, H, W, C = x.shape
    k, p = module.kernel_size, module.padding
    x = x.contiguous()
    ii = torch.arange(H, dtype=x.dtype).view(1, H, 1)
    jj = torch.arange(W, dtype=x.dtype).view(1, 1, W)
    taps = []
    for kh in range(k):
        for kw in range(k):
            t = kh * k + kw
            sy = (ii + (kh - p)) + offset[..., 2 * t]
            sx = (jj + (kw - p)) + offset[..., 2 * t + 1]
            taps.append(bilinear.bilinear_gather(x, sx.float().contiguous(),
                                                 sy.float().contiguous(), padding_mode="zeros"))
    w = module.weight.permute(2, 3, 1, 0).reshape(k * k * C, -1)
    return torch.cat(taps, dim=-1) @ w + module.bias


def _inputs(seed, shape=(2, 9, 7, 6), features=5, scale=1.5):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    offset = torch.from_numpy((scale * rng.normal(size=(B, H, W, 18))).astype(np.float32))
    module = resample.DeformConv2d(C, features)
    module.init_weights_(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        module.bias.normal_(generator=torch.Generator().manual_seed(seed + 1))
    g = torch.from_numpy(rng.normal(size=(B, H, W, features)).astype(np.float32))
    return module, x, offset, g


@pytest.mark.parametrize("scale", [0.3, 1.5, 6.0])
def test_one_multiview_gather_equals_nine_gathers(scale):
    """Offsets of 0.3, 1.5 and 6 px (taps far outside the image)."""
    module, x, offset, _ = _inputs(0, scale=scale)
    with torch.no_grad():
        torch.testing.assert_close(module(x, offset), nine_gathers(module, x, offset),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("seed", [1, 2])
def test_gradients_match_nine_gathers(seed):
    module, x, offset, g = _inputs(seed)
    grads = []
    for forward in (module, lambda a, o: nine_gathers(module, a, o)):
        module.zero_grad()
        a, o = x.clone().requires_grad_(), offset.clone().requires_grad_()
        forward(a, o).backward(g)
        grads.append([a.grad, o.grad, module.weight.grad.clone(), module.bias.grad.clone()])
    for name, got, want in zip(("x", "offset", "weight", "bias"), *grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=name)


def test_cpu_forward_and_backward_launch_no_kernel():
    """On the CPU the one gather runs the plain versions: no kernel launch."""
    module, x, offset, g = _inputs(3)
    counters = (bilinear.bilinear_gather, bilinear.bilinear_gather_backward,
                bilinear.bilinear_gather_multiview, bilinear.bilinear_gather_multiview_backward)
    before = [c.launches for c in counters]
    module(x.requires_grad_(), offset).backward(g)
    assert [c.launches for c in counters] == before
