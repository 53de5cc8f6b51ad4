"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, else the
fixed git-ignored .jax_cache/ at the root of the checkout."""

import os
import subprocess
import sys
import time

import pytest

from kmerax.utils.compile_cache import REPO_CACHE

ROOT = os.path.dirname(REPO_CACHE)
_PROG = """
import jax, jax.numpy as jnp
from kmerax.utils.compile_cache import enable
print(enable())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.cumsum(x * 3 + 1) - {salt})(jnp.arange(11)).block_until_ready()
"""


def _newer_files(d, t0):
    return [f for f in os.listdir(d)
            if os.path.getmtime(os.path.join(d, f)) >= t0] \
        if os.path.isdir(d) else []


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_lands_in_place(tmp_path, env_set):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    want = str(tmp_path / "cache") if env_set else REPO_CACHE
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    t0 = time.time() - 1
    out = subprocess.run(
        [sys.executable, "-c", _PROG.format(salt=time.time_ns() % 9973)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
    assert _newer_files(want, t0), f"no cache entry written under {want}"
