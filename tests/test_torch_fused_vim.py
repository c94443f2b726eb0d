"""EnhancedViMBlock's three layouts against the JAX package, on the CPU.

The block at C=16 on 8 x 8 maps (B=2), as tests/test_fused_vim.py runs it,
with converted, perturbed weights (tests/torch_parity.py): ``impl="fused"``
in both packings and ``impl="vmap"`` against JAX's block of the same impl,
in eval mode within 1e-4 abs, and in training mode (the batch's BatchNorm
statistics, flax's; no stochastic depth) within 1e-4 with the running
statistics after it, and d sum(out**2) / dx within 1e-4 of its largest. The
layouts against each other: ``unfuse_direction_params(
fuse_direction_params(sd))`` returns the separate state dict bit for bit,
and the fused block loaded from it equals the separate one within
tests/test_fused_vim.py's bounds (1e-5 relative, 2e-5 absolute) in both
packings; the converter reads the JAX vmap layout's stacked leaves
(``vit_mamba3``, ``attn3``) and the port's vmap block initialises each
branch on its own. Each JAX function is jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.models.km_unet import EnhancedViMBlock as EnhancedViMBlock_jax
from kmunet_tpu_torch import convert
from kmunet_tpu_torch.models.km_unet import EnhancedViMBlock
from kmunet_tpu_torch.nn.fused_vim import (FusedDirectionViM, fuse_direction_params,
                                           unfuse_direction_params)
from kmunet_tpu_torch.nn.init import init_module_
from tests.torch_parity import init_perturbed, nchw, port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4
C = 16
LAYOUTS = [("fused", "grouped"), ("fused", "blockdiag"), ("vmap", "grouped")]


def _x(seed=0, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, 8, 8, C)).astype(np.float32)


def _jax(impl, packing):
    return EnhancedViMBlock_jax(state_dim=16, impl=impl, packing=packing, drop_path=0.0)


def _port(impl, packing="grouped"):
    return EnhancedViMBlock(C, impl=impl, packing=packing, drop_path=0.0)


@pytest.mark.parametrize("impl,packing", LAYOUTS)
def test_layout_matches_jax(impl, packing):
    jm, x = _jax(impl, packing), _x()
    v = init_perturbed(jm, x, seed=1)
    tm = port(_port(impl, packing), v)
    want = np.asarray(jax.jit(jm.apply)(v, x)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    g_want = jax.jit(jax.grad(lambda xx: jnp.sum(jm.apply(v, xx) ** 2)))(x)
    xt = nchw(x).requires_grad_()
    tm(xt).square().sum().backward()
    g_want = np.asarray(g_want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * np.abs(g_want).max())

    want_t, upd = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(v, x)
    tm.train()
    with torch.no_grad():
        got_t = tm(nchw(x)).numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t).transpose(0, 3, 1, 2), rtol=0, atol=ATOL)
    stats = convert.to_state_dict(_port(impl, packing), v["params"], upd["batch_stats"])
    moved = [k for k in stats if "running_" in k]
    assert moved
    for key in moved:
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), stats[key].numpy(), rtol=0,
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("packing", ["grouped", "blockdiag"])
def test_fuse_and_unfuse_move_a_checkpoint_between_layouts(packing):
    jm, x = _jax("separate", "grouped"), _x(3)
    sep = port(_port("separate"), init_perturbed(jm, x, seed=4))
    sd = sep.state_dict()
    back = unfuse_direction_params(fuse_direction_params(sd))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    fused = _port("fused", packing)
    fused.load_state_dict(fuse_direction_params(sd), strict=True)
    fused.eval()
    with torch.no_grad():
        want = sep(nchw(x)).numpy()
        got = fused(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    # and back: the fused block's own state dict restores the separate block
    again = _port("separate")
    again.load_state_dict(unfuse_direction_params(fused.state_dict()), strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(again.eval()(nchw(x)).numpy(), want)


def test_vmap_branches_initialise_apart_and_stack_their_leaves():
    block = _port("vmap")
    init_module_(block, torch.Generator().manual_seed(0))
    a = block.vit_mamba3.mixer.BCdt_proj
    assert a.shape == (3, 3 * 64, C)
    assert not torch.equal(a[0], a[1])
    bound = 1.0 / C ** 0.5  # kaiming over one branch's fan, not the stack's
    assert float(a.abs().max()) <= bound and float(a.abs().max()) > 0.5 * bound
    assert torch.all((block.vit_mamba3.mixer.A >= 1.0) & (block.vit_mamba3.mixer.A <= 16.0))
    assert block.attn3.qkv.weight.shape == (3, 3 * C, C, 1, 1)


def test_fused_layout_initialises_per_branch():
    fused = FusedDirectionViM(C)
    init_module_(fused, torch.Generator().manual_seed(1))
    assert float(fused.hz_weight.abs().max()) <= 1.0 / C ** 0.5
    assert float(fused.dw1_weight.abs().max()) <= 1.0 / 3.0
    assert float(fused.bn1.weight.abs().max()) == 0.0  # the residual stages start as identity
