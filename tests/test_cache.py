"""The persistent compilation cache helper every entry point calls."""

import os

import jax

from cuda_recommender_tpu.utils.cache import (DEFAULT_DIR, compile_cache_dir,
                                              enable_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_when_set():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/shared/cache"}
    assert compile_cache_dir(env) == "/some/shared/cache"


def test_fixed_in_checkout_dir_when_unset():
    assert compile_cache_dir({}) == DEFAULT_DIR
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == DEFAULT_DIR
    # one fixed path inside the checkout, and git ignores it
    assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_backend_keeps_no_cache():
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
