"""The port stands alone: no module of ``kmunet_tpu_torch``, not
``chip_smoke.py`` and not the port's scripts import JAX, flax or the JAX
package (the machine with the card has none of them)."""

import ast
import pathlib
import subprocess
import sys

import pytest
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kmunet_tpu")
# The port's scripts that run on the card; scripts/torch_grad_precision.py
# imports JAX on purpose, behind --jax, and stays out.
SCRIPTS = [REPO / "scripts" / "torch_ablate_mix_kernel.py",
           REPO / "scripts" / "profile_torch_forward.py",
           REPO / "scripts" / "torch_kernel_timing.py",
           REPO / "scripts" / "torch_ablate_variants.py",
           REPO / "scripts" / "torch_train_shanghai.py",
           REPO / "scripts" / "torch_train_laps.py",
           REPO / "scripts" / "torch_evaluate.py",
           REPO / "scripts" / "torch_predict.py",
           REPO / "scripts" / "torch_one_card_timing.py",
           REPO / "scripts" / "torch_train_baseline.py"]
SOURCES = sorted((REPO / "kmunet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] + SCRIPTS


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    roots = {name.split(".")[0] for name in _imported_roots(path)}
    assert not roots & set(FORBIDDEN), f"{path.name} imports {sorted(roots & set(FORBIDDEN))}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        "import kmunet_tpu_torch.serve, kmunet_tpu_torch.convert, kmunet_tpu_torch.kernels.bilinear\n"
        "import kmunet_tpu_torch.kernels.ablate_mix, kmunet_tpu_torch.utils.profiler\n"
        "import kmunet_tpu_torch.models.efficient_vim, kmunet_tpu_torch.nn.fused_vim\n"
        "import kmunet_tpu_torch.nn.kan_variants\n"
        "import runpy\n"
        f"for path in {[str(p) for p in SCRIPTS]!r}:\n"
        "    runpy.run_path(path, run_name='imported')\n"
        "import pkgutil, importlib, kmunet_tpu_torch\n"
        "for m in pkgutil.walk_packages(kmunet_tpu_torch.__path__, 'kmunet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("module", ["models/efficient_vim.py", "nn/fused_vim.py",
                                    "nn/kan_variants.py"])
def test_new_modules_are_checked(module):
    """The classifier, the ViM layouts and the KAN variants are among the
    sources the import check walks."""
    assert REPO / "kmunet_tpu_torch" / module in SOURCES
