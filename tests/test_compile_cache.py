"""The one compile-cache helper: JAX_COMPILATION_CACHE_DIR when set,
otherwise <checkout>/.jax_cache; no other code names a cache directory."""

import os
import subprocess

import jax

from fhe_fed_tpu.utils import compile_cache as CC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restoring(fn):
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        return fn(), jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    got, after = _restoring(CC.enable_compile_cache)
    assert got == str(tmp_path)
    assert after == before


def test_unset_env_uses_checkout_cache(monkeypatch):
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    got, after = _restoring(CC.enable_compile_cache)
    assert got == after == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_only_the_helper_names_a_cache_dir():
    out = subprocess.run(
        ["git", "grep", "-l", "--untracked", "jax_compilation_cache_dir",
         "--", "*.py"],
        cwd=REPO, capture_output=True, text=True)
    if out.returncode not in (0, 1):     # not a git checkout: scan by hand
        files = []
        for d, dirs, fs in os.walk(REPO):
            dirs[:] = [x for x in dirs if not x.startswith(".")]
            files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
        hits = [os.path.relpath(f, REPO) for f in files
                if "jax_compilation_cache_dir" in open(f).read()]
    else:
        hits = out.stdout.split()
    assert sorted(hits) == ["fhe_fed_tpu/utils/compile_cache.py",
                            "tests/test_compile_cache.py"]
