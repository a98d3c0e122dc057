"""The compile-cache helper: the environment wins, else one fixed path."""

import pathlib

from pyimcom_tpu import jaxcache


def test_cache_dir_honours_environment():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}
    assert jaxcache.cache_dir(env) == "/somewhere/cache"


def test_cache_dir_defaults_to_fixed_checkout_path():
    repo = pathlib.Path(jaxcache.__file__).resolve().parent.parent
    assert jaxcache.cache_dir({}) == str(repo / ".jax_cache")
    # the same path every call: it is part of the cache key
    assert jaxcache.cache_dir({}) == jaxcache.cache_dir({"OTHER": "1"})
    ignored = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
