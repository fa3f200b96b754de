"""Where the persistent XLA compile cache goes: JAX_COMPILATION_CACHE_DIR
when it is set (the package then sets no directory), else one fixed
directory inside the checkout, next to the package."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_placement(env_set, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"  # place, never write
    want = str(tmp_path / "xla")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = os.path.join(REPO, ".xla_cache")
    code = ("import jax, mgard_tpu; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(mgard_tpu.CACHE_DIR)")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got, default_dir = res.stdout.strip().splitlines()[-2:]
    assert got == want
    assert default_dir == os.path.join(REPO, ".xla_cache")
