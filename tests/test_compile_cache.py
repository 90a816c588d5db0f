"""Placement of JAX's persistent compile cache (qcnn_gpu/compile_cache.py)."""

import os

import jax
import pytest

from qcnn_gpu import compile_cache as CC

pytestmark = pytest.mark.quick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_fixed_dir_at_checkout_root(monkeypatch):
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    assert CC.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    assert CC.cache_dir() == str(tmp_path)


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_sets_a_directory_only_when_env_unset(monkeypatch, tmp_path, env_set):
    """With the variable set, JAX already reads it and code sets nothing;
    without it, the fixed directory is configured."""
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_set:
        monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(CC.ENV_VAR, raising=False)
    got = CC.enable_compile_cache()
    if env_set:
        assert got == str(tmp_path) and updates == []
    else:
        assert got == CC.DEFAULT_DIR
        assert updates == [("jax_compilation_cache_dir", CC.DEFAULT_DIR)]


def test_gitignore_lists_cache_dir():
    with open(os.path.join(ROOT, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()
