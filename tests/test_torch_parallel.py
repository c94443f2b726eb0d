"""The port's device mesh against ``kmunet_tpu/parallel/mesh.py``.

``MeshSpec.resolve`` and ``make_mesh``'s refusals on a table of specs and
world sizes give JAX's results and JAX's ``ValueError`` messages; on 4 gloo
ranks each rank's coordinates are its place in JAX's device array of the
same spec. ``param_sharding_rules`` picks the same leaves of the SH model
at 32^2, on the same logical axes, as JAX's on 2 and 4 of the conftest's
virtual devices (the flax leaf's axis taken through the converter's
permutation). The loader's rows of each rank over two epochs are the
blocks of JAX's loader's global batches on the same mesh. Under
``torch.distributed.run`` (torchrun, gloo), ``engine.main`` trains from
the environment's ranks.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.configs as configs_jax
import kmunet_tpu.train.engine as engine_jax
from kmunet_tpu.data import DataLoader as DataLoaderJax
from kmunet_tpu.data import SyntheticNowcastDataset as SyntheticJax
from kmunet_tpu.parallel import MeshSpec as MeshSpecJax
from kmunet_tpu.parallel import batch_sharding as batch_sharding_jax
from kmunet_tpu.parallel import make_mesh as make_mesh_jax
from kmunet_tpu.parallel import param_sharding_rules as rules_jax
from kmunet_tpu_torch import configs, convert
from kmunet_tpu_torch.data import DataLoader, SyntheticNowcastDataset
from kmunet_tpu_torch.parallel import (Mesh, MeshSpec, batch_sharding, init_distributed,
                                       make_mesh, param_sharding_rules, shard_params)
from kmunet_tpu_torch.models import zoo
from kmunet_tpu_torch.train import engine
from tests import torch_ranks
from tests.torch_parity import init_perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = [(-1, 1, 1), (2, 1, 1), (4, 1, 1), (-1, 2, 1), (-1, 1, 2), (1, 2, 2), (2, -1, 1),
         (1, 1, -1), (3, 1, 1), (-1, -1, 1), (2, 2, 2), (1, 4, 1), (8, 1, 1), (-1, 1, 4)]
WORLDS = [1, 2, 4, 8]


def _outcome(resolve):
    try:
        return ("ok", tuple(resolve()))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_spec_resolve_matches_jax(world):
    for spec in SPECS:
        assert _outcome(lambda: MeshSpec(*spec).resolve(world)) == _outcome(
            lambda: MeshSpecJax(*spec).resolve(world)), spec


def test_make_mesh_refuses_what_jax_refuses():
    """Every spec and world of the table: where JAX's ``make_mesh`` raises,
    the port's raises the same ``ValueError``; where JAX's builds a mesh of
    more than one device, the port's (in one process) raises that the world
    has one process; at one device both build a 1 x 1 x 1 mesh."""
    for world in WORLDS:
        devices = jax.devices()[:world]
        for spec in SPECS:
            for allow in (False, True):
                try:
                    want = dict(make_mesh_jax(MeshSpecJax(*spec), devices=devices,
                                              allow_spatial_with_model=allow).shape)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        make_mesh(MeshSpec(*spec), world=world, allow_spatial_with_model=allow)
                    assert str(got.value) == str(e), (spec, world)
                    continue
                if world > 1:
                    with pytest.raises(ValueError, match="this run has 1 process"):
                        make_mesh(MeshSpec(*spec), world=world, allow_spatial_with_model=allow)
                else:
                    assert make_mesh(MeshSpec(*spec)).shape == want
    assert "combining spatial>1" in _outcome(
        lambda: make_mesh(MeshSpec(1, 2, 2), world=4))[1]


def test_init_distributed_without_ranks_is_one_process(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "spatial": 1, "model": 1}
    assert mesh.axis("data").group is None


RANK_SPECS = [(4, 1, 1), (-1, 1, 1), (2, 1, 2), (1, 4, 1), (2, 2, 1), (1, 1, 4), (1, 2, 2)]


def test_make_mesh_on_ranks_matches_jax_layout(tmp_path):
    """On 4 gloo ranks: each rank's coordinates are where JAX puts device r
    in the same spec's mesh; the axes' sizes and indices follow; the spec
    that JAX refuses raises on every rank; a CUDA device on a gloo group
    raises instead of running on gloo."""
    specs = [s for s in RANK_SPECS if s != (1, 2, 2)]
    ranks = torch_ranks.spawn(torch_ranks.run_jobs, 4, tmp_path,
                              [(torch_ranks.mesh_job, (specs,)),
                               (torch_ranks.refusals_job, ((1, 2, 2),))])
    devices = jax.devices()[:4]
    for spec in specs:
        want = make_mesh_jax(MeshSpecJax(*spec), devices=devices)
        ids = np.vectorize(lambda d: devices.index(d))(want.devices)
        for r, (got, refusals) in enumerate(ranks):
            g = got[spec]
            assert g["shape"] == dict(want.shape) and g["ranks"] == ids.tolist()
            coords = tuple(int(i) for i in np.argwhere(ids == r)[0])
            assert tuple(g["coords"][a] for a in ("data", "spatial", "model")) == coords
            d, s, m = ids.shape
            assert g["axes"]["data"] == (d, coords[0])
            assert g["axes"]["model"] == (m, coords[2])
            assert g["axes"][("data", "model")] == (d * m, coords[0] * m + coords[2])
    for _, refusals in ranks:
        assert "combining spatial>1" in refusals["mesh"]
        assert "need nccl" in refusals["cuda_on_gloo"]


def _mesh(data=1, model=1, index=(0, 0)):
    """A mesh of ``data`` x 1 x ``model`` ranks seen from the rank at
    (data index, model index), without process groups: what the rules and
    the loader read of it."""
    ranks = np.arange(data * model).reshape(data, 1, model)
    return Mesh(ranks, int(ranks[index[0], 0, index[1]]), {})


@pytest.fixture(scope="module")
def sh_params():
    """The SH model's flax params (shapes only; numpy values) at 32^2 and the
    port model's parameters."""
    cfg = configs_jax.shanghai_km_unet()
    cfg.data.img_size, cfg.model.num_classes = 32, 4
    variables = init_perturbed(engine_jax.build_model(cfg), jnp.zeros((1, 32, 32, 5)), seed=0)
    cfg = configs.shanghai_km_unet()
    cfg.model.num_classes = 4
    model = zoo.init_weights_(engine.build_model(cfg), torch.Generator().manual_seed(0))
    return variables["params"], dict(model.named_parameters())


class _Axes:
    """Records the permutation ``convert._convert_leaf`` applies to a leaf."""

    def __init__(self, ndim):
        self.ndim, self.perm = ndim, tuple(range(ndim))

    def transpose(self, perm):
        self.perm = tuple(perm)
        return self


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("min_size", [4096, 1024])
def test_param_sharding_rules_match_jax(sh_params, model, min_size):
    flax_params, params = sh_params
    mesh_jax = make_mesh_jax(MeshSpecJax(1, 1, model), devices=jax.devices()[:model])
    rules = rules_jax(mesh_jax, flax_params, fsdp=True, min_size=min_size)
    want = {}
    for path, sharding in _flatten(jax.tree.map(lambda s: s, rules,
                                                is_leaf=lambda s: hasattr(s, "spec"))):
        leaf = dict(_flatten(flax_params))[path]
        axes = _Axes(leaf.ndim)
        key, _ = convert._convert_leaf(path, axes)
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
        want[key] = axes.perm.index(spec.index("model")) if "model" in spec else None
    got = param_sharding_rules(_mesh(model=model), params, fsdp=True, min_size=min_size)
    assert got == want
    assert sum(a is not None for a in got.values()) >= 50
    assert set(param_sharding_rules(_mesh(model=model), params).values()) == {None}
    assert set(param_sharding_rules(_mesh(), params, fsdp=True).values()) == {None}
    # Each rank's blocks, put side by side, are the leaf.
    blocks = [shard_params(params, got, _mesh(model=model, index=(0, j))) for j in range(model)]
    for key, dim in got.items():
        whole = torch.cat([b[key] for b in blocks], dim=dim) if dim is not None else blocks[0][key]
        assert torch.equal(whole, params[key].detach()), key


def test_batch_sharding_is_jax_blocks():
    batch = torch.arange(8 * 3.0).reshape(8, 3)
    mesh_jax = make_mesh_jax(MeshSpecJax(4, 1, 1), devices=jax.devices()[:4])
    arr = jax.device_put(batch.numpy(), batch_sharding_jax(mesh_jax, ndim=2))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for i, device in enumerate(mesh_jax.devices[:, 0, 0]):
        np.testing.assert_array_equal(batch_sharding(_mesh(data=4, index=(i, 0)), batch).numpy(),
                                      by_device[device])
    with pytest.raises(ValueError, match="not divisible by data=3"):
        batch_sharding(_mesh(data=3), batch)


@pytest.mark.parametrize("data", [2, 4])
def test_loader_rows_are_jax_blocks(data):
    """Two shuffled epochs: rank i's batches are the rows JAX's loader puts
    on data index i of each global batch; ``len`` counts global batches."""
    ds = SyntheticNowcastDataset(length=13, img_size=8, seq_len=3, seed=4)
    ref_ds = SyntheticJax(length=13, img_size=8, seq_len=3, seed=4)
    mesh_jax = make_mesh_jax(MeshSpecJax(data, 1, 1), devices=jax.devices()[:data])
    ref = DataLoaderJax(ref_ds, 4, shuffle=True, seed=7, num_workers=2,
                        sharding=batch_sharding_jax(mesh_jax, ndim=4),
                        process_index=0, process_count=1)
    ours = [DataLoader(ds, 4, shuffle=True, seed=7, num_workers=2, device="cpu",
                       mesh=_mesh(data=data, index=(i, 0))) for i in range(data)]
    assert all(len(ld) == len(ref) == 3 for ld in ours)
    for _ in range(2):
        want = list(ref)
        got = [list(ld) for ld in ours]
        for b, arr in enumerate(want):
            by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
            for i, device in enumerate(mesh_jax.devices[:, 0, 0]):
                np.testing.assert_array_equal(got[i][b].numpy(), by_device[device])
    with pytest.raises(ValueError, match="not divisible by data=3"):
        DataLoader(ds, 4, device="cpu", mesh=_mesh(data=3))
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(ds, 4, drop_last=False, device="cpu", mesh=_mesh(data=2))


def test_main_trains_under_torchrun(tmp_path):
    """``torch.distributed.run`` (torchrun) with 2 gloo processes on
    ``engine.main``'s command line (the JAX CLI's arguments): each rank joins
    from the environment, trains its rows, and rank 0 writes results.json."""
    out = tmp_path / "out"
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from kmunet_tpu_torch.train import engine\n"
            "engine.main(sys.argv[1:], device='cpu')\n")
    script = tmp_path / "train.py"
    script.write_text(code)
    argv = ["--config=synthetic", "--max_steps=1", "--data.img_size=32", "--data.batch_size=4",
            "--data.seq_len=9", "--data.out_frames=4", "--model.num_classes=4",
            "--data.synthetic_length=8", "--data.num_workers=1", "--train.epochs=1",
            "--train.vis_batches=0", "--train.compute_dtype=float32", f"--train.out_dir={out}"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", str(script), *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "results.json") as f:
        written = json.load(f)
    assert written["steps"] == 1 and written["batch_size"] == 4
    assert proc.stdout.count("epoch 0:") == 1  # rank 0 alone logs
