"""The kernels' build cache (``repro_torch.runtime.compile_cache``): where
``CudaKernel.library`` and ``.log`` point under each knob. Nothing is
built (no ``nvcc`` runs on the CPU)."""
from pathlib import Path

import pytest

from repro_torch.kernels import KERNELS
from repro_torch.runtime import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cache(monkeypatch):
    monkeypatch.delenv("REPRO_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("REPRO_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    return monkeypatch


def test_default_is_build_kernels(cache):
    assert compile_cache.cache_dir() == REPO / "build" / "kernels"
    for k in KERNELS:
        assert k.library.parent == REPO / "build" / "kernels"
        assert k.log == REPO / "build" / "kernels" / f"{k.library_name}.log"
        assert k.library.name.startswith(f"lib{k.library_name}-")


def test_env_dir_redirects_the_cache(cache, tmp_path):
    cache.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == tmp_path
    assert all(k.library.parent == tmp_path and k.log.parent == tmp_path for k in KERNELS)
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert compile_cache.enable_persistent_cache(str(tmp_path / "x")) == str(tmp_path / "x")
    assert KERNELS[0].library.parent == tmp_path / "x"


def test_opt_out_builds_into_a_private_temporary_dir(cache):
    cache.setenv("REPRO_NO_COMPILE_CACHE", "1")
    cache.setattr(compile_cache, "_private_dir", None)
    assert compile_cache.enable_persistent_cache() is None
    first = compile_cache.cache_dir()
    assert first.is_dir() and first != REPO / "build" / "kernels"
    assert compile_cache.cache_dir() == first  # one per process
    assert all(k.library.parent == first for k in KERNELS)


def test_launchers_enable_the_cache():
    for mod in ("serve", "train"):
        text = (REPO / "src" / "repro_torch" / "launch" / f"{mod}.py").read_text()
        assert "enable_persistent_cache()" in text
