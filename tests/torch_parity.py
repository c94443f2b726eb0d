"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

A JAX module and its port run on the same inputs and the same weights: every
flax variable is drawn as a seeded random value, in place of its init (so
that no branch is switched off by its init: zero BN scales, sigmoid(alpha)
near 0.5), and the port loads them through
``kmunet_tpu_torch.convert``. Data crosses between the two as numpy arrays.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch

from kmunet_tpu_torch.convert import load_flax


def _perturbed_leaf(name, shape, rng):
    u = lambda lo, hi: rng.uniform(lo, hi, shape)  # noqa: E731
    if name == "var":
        out = u(0.5, 1.5)  # BN variances stay positive
    elif name in ("scale", "D"):
        out = u(0.5, 1.5)
    elif name in ("bias", "mean"):
        out = u(-0.3, 0.3)
    elif name == "alpha":
        out = rng.normal(0.0, 1.5, shape)
    elif name == "A":
        out = u(0.0, 4.0)
    elif name == "spline_scaler":
        out = u(-1.0, 1.0)
    else:  # kernels, in flax layout (..., in, out)
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else 1
        out = u(-1.0, 1.0) * 1.5 / math.sqrt(fan_in)
    return out.astype(np.float32)


def init_perturbed(module, *inputs, seed: int = 0, **kwargs):
    """Seeded random values (numpy) for every variable of the flax ``module``
    applied to ``inputs``. Only the variables' shapes are traced
    (``jax.eval_shape``): the module's own init would not be used anyway."""
    init = functools.partial(module.init, **kwargs)  # static flags such as train
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {
            k: walk(v) if isinstance(v, Mapping) else _perturbed_leaf(k, v.shape, rng)
            for k, v in tree.items()
        }

    return walk(shapes)


def port(torch_module, variables):
    """``torch_module`` in eval mode with the flax ``variables`` loaded."""
    load_flax(torch_module, variables["params"], variables.get("batch_stats"))
    return torch_module.eval()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for the importing test module: the tests
    run at small shapes, where one thread is about as fast as eight, and
    the tier-1 run's six xdist workers share eight cores (with the default
    eight threads each, one file took 1,236 s there, 43 s pinned). A module
    that imports this fixture gets it, autouse."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
