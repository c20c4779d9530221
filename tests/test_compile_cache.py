"""The one compile-cache location: $JAX_COMPILATION_CACHE_DIR when set,
<repo>/.jax_cache otherwise — never a temporary directory."""

import os

import jax

from asvgp.utils import compile_cache


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    target = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    assert compile_cache.compile_cache_dir() == target
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert compile_cache.enable_compile_cache() == target
        assert os.path.isdir(target)
        assert jax.config.jax_compilation_cache_dir == target
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert not path.startswith("/tmp")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
