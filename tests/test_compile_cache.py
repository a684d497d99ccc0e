"""The compile-cache rule shared by the entry points
(utils/compile_cache.py): ``JAX_COMPILATION_CACHE_DIR`` wins and nothing is
set in code; otherwise the fixed ``<repo>/.jax_cache``."""
import os

from infiniteexamodels_jax.utils import compile_cache


def test_env_set_is_used_and_nothing_set(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert calls == []


def test_env_unset_uses_repo_cache(monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.use_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    assert compile_cache.REPO_ROOT == root
