"""The repository's scripts: the compile-cache location they share, and
``chip_smoke.py`` refusing to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from xhistogram_tpu.utils.compile_cache import compile_cache_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_repo_dir(tmp_path):
    path, from_env = compile_cache_dir(str(tmp_path), environ={})
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    assert not from_env


def test_compile_cache_env_wins(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": "/cache/elsewhere"}
    path, from_env = compile_cache_dir(str(tmp_path), environ=env)
    assert (path, from_env) == ("/cache/elsewhere", True)


def _run_smoke(script, cwd):
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def _is_contract_line(line):
    try:
        return json.loads(line).get("ok") is True
    except (ValueError, AttributeError):
        return False


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    """No nvidia-smi on PATH (no GPU): a non-zero exit naming the missing
    device, no phase run, no result line — also from a directory holding
    only the script."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    res = _run_smoke(str(script), str(tmp_path))
    assert res.returncode != 0
    assert "GPU" in res.stderr
    lines = res.stdout.strip().splitlines()
    assert not any(_is_contract_line(ln) for ln in lines)
    assert '"phase"' not in res.stdout
