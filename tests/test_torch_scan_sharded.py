"""The port's sequence-parallel selective scan (``ops/scan.py::
selective_scan_sharded``) on gloo ranks.

Over 2 and 4 ranks on 'spatial' (and dp2 x sp2, the batch cut over 'data'),
y and the gradients of sum(y * g) to all six inputs against the port's
plain scan, within 1e-5 relative + 1e-6 of the tensor's largest |value|
(ddt's elements are sums that cancel: at L=256 one of -0.083 lies 5.4e-6
from the plain scan's where the largest is 74), and against JAX's
``selective_scan_sharded`` on 2 and 4 of the conftest's virtual devices
within 1e-4; an L the axis does not divide runs the plain scan, as in JAX.
``Mamba_UNet(seq_mesh=...)`` against the unsharded port model, as
tests/test_scan_sharded.py holds JAX's. One spawn per world size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.ops.scan import selective_scan_sharded as sharded_jax
from kmunet_tpu.parallel import MeshSpec as MeshSpecJax
from kmunet_tpu.parallel import make_mesh as make_mesh_jax
from kmunet_tpu_torch.models import mamba_unet, zoo
from kmunet_tpu_torch.ops.scan import selective_scan
from tests import torch_ranks

RTOL, ATOL = 1e-5, 1e-6
JAX_TOL = 1e-4
# (B, L, D, N): L splits over 2 and 4 ranks; L = 10 does not split over 4.
SHAPES = [(2, 64, 4, 3), (4, 256, 8, 16), (2, 10, 3, 2)]
MESHES = {2: [(1, 2, 1)], 4: [(1, 4, 1), (2, 2, 1)]}
NAMES = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Per world size, per mesh: every rank's scans, and Mamba-UNet's output."""
    tmp = tmp_path_factory.mktemp("scan")
    x = np.random.default_rng(5).normal(size=(4, 32, 32, 5)).astype(np.float32) * 0.3
    out = {}
    for world, specs in MESHES.items():
        jobs = [(torch_ranks.scan_job, (spec, SHAPES)) for spec in specs]
        jobs += [(torch_ranks.mamba_job, (spec, x)) for spec in specs]
        got = torch_ranks.spawn(torch_ranks.run_jobs, world, tmp, jobs, timeout=300)
        for i, spec in enumerate(specs):
            out[spec] = ([r[i] for r in got], [r[len(specs) + i] for r in got])
    return x, out


def _rows(t, spec, rank):
    """The rows of a whole (B, ...) tensor that ``rank`` holds on the mesh of ``spec``."""
    data = spec[0]
    index = rank // (spec[1] * spec[2])
    rows = t.shape[0] // data
    return t[index * rows:(index + 1) * rows]


def _plain(shape):
    *args, g = (torch.from_numpy(a) for a in torch_ranks.scan_inputs(shape))
    args = [a.clone().requires_grad_() for a in args]
    y = selective_scan(*args)
    return [y.detach()] + list(torch.autograd.grad((y * g).sum(), args))


@pytest.mark.parametrize("spec", [s for specs in MESHES.values() for s in specs],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"L{s[1]}")
def test_sharded_scan_matches_plain_scan(ranks, spec, shape):
    want = _plain(shape)
    for r, rank in enumerate(ranks[1][spec][0]):
        for name, got, w in zip(NAMES, rank[shape], want):
            # A and D are whole on every rank; the rest are the rank's rows.
            w = w if name in ("dA", "dD") else _rows(w, spec, r)
            if name in ("dA", "dD") and spec[0] > 1:
                continue  # a data split sums these over the data ranks in the trainer
            torch.testing.assert_close(got, w, rtol=RTOL, atol=ATOL * float(w.abs().max()),
                                       msg=f"{name} rank {r}")
            if shape[1] % spec[1]:
                assert torch.equal(got, w), name  # the plain scan, as JAX's eligibility rule


def _jax_scan(mesh):
    """y and the VJP of JAX's sharded scan for the upstream g, jitted."""
    def scan(*args):
        *args, g = args
        y, vjp = jax.vjp(lambda *a: sharded_jax(*a, mesh=mesh, axis="spatial"), *args)
        return (y, *vjp(g))

    return jax.jit(scan)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_scan_matches_jax(ranks, n):
    """y and the six gradients against JAX's sharded scan (``jax.vjp``
    through its shard_map) on ``n`` virtual devices."""
    mesh = make_mesh_jax(MeshSpecJax(1, n, 1), devices=jax.devices()[:n])
    for shape in SHAPES[:2]:
        want = _jax_scan(mesh)(*(jnp.asarray(a) for a in torch_ranks.scan_inputs(shape)))
        for r, rank in enumerate(ranks[1][(1, n, 1)][0]):
            for name, got, w in zip(NAMES, rank[shape], want):
                np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=JAX_TOL,
                                           atol=JAX_TOL, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("spec", [s for specs in MESHES.values() for s in specs],
                         ids=lambda s: "x".join(map(str, s)))
def test_mamba_unet_seq_mesh_matches_unsharded(ranks, spec):
    """Every DMFM's scan over the 'spatial' ranks (L of 1024 down to 1: the
    deepest levels run the plain scan), the batch cut over 'data': each
    rank's output within 2e-4 of the unsharded model's rows (JAX's test's
    bound)."""
    x, out = ranks
    model = mamba_unet.Mamba_UNet(predicted_frames=3, bridge=False)
    zoo.init_weights_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x))
    for r, got in enumerate(out[spec][1]):
        assert got.shape == _rows(want, spec, r).shape
        torch.testing.assert_close(got, _rows(want, spec, r), rtol=0, atol=2e-4)
