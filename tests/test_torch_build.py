"""The port's kernel build (kmunet_tpu_torch/kernels/build.py), with a stand-in
for nvcc: hash-named libraries, rebuilt when the source or a header beside it
changes, reused otherwise, written under a temporary name, and a clear error without nvcc."""

import subprocess

import pytest

from kmunet_tpu_torch.kernels import build
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    calls = []

    def fake_nvcc(cmd, **kwargs):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        assert ".tmp" in out  # the compiler never writes the final name
        with open(out, "w") as f:
            f.write("library")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info : Used 32 registers")

    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    return csrc, calls


def test_build_names_by_hash_and_reuses(tree):
    csrc, calls = tree
    first = build.build("k.cu")
    assert first.path.exists() and first.path.parent == build.BUILD_DIR
    assert first.path.name.startswith("k_") and first.path.suffix == ".so"
    assert "Used 32 registers" in first.compiler_output
    again = build.build("k.cu")
    assert again.path == first.path and again.seconds == 0.0 and len(calls) == 1
    (csrc / "k.cu").write_text("// v2\n")
    changed = build.build("k.cu")
    assert changed.path != first.path and len(calls) == 2
    assert not list(build.BUILD_DIR.glob("*.tmp*"))
    flags = calls[0]
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def test_changed_header_rebuilds(tree):
    """A source includes the headers beside it by name: changing one rebuilds."""
    csrc, calls = tree
    (csrc / "h.cuh").write_text("// v1\n")
    first = build.build("k.cu")
    assert build.build("k.cu").path == first.path and len(calls) == 1
    (csrc / "h.cuh").write_text("// v2\n")
    assert build.build("k.cu").path != first.path and len(calls) == 2


def test_failed_compile_raises_and_leaves_nothing(tree, monkeypatch):
    def failing_nvcc(cmd, **kwargs):
        return subprocess.CompletedProcess(cmd, 1, "", "error: expected ';'")

    monkeypatch.setattr(build.subprocess, "run", failing_nvcc)
    with pytest.raises(RuntimeError, match="expected ';'"):
        build.build("k.cu")
    assert not list(build.BUILD_DIR.glob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
