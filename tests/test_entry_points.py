"""Entry points on a host without a GPU: they refuse to run rather than fall
back to the CPU, and the compile cache lands where it is documented to."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compilation_cache_dir(monkeypatch, tmp_path, env_dir):
    import jax

    from stereo_vo.utils import cache

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(tmp_path / ".jax_cache"))
        want = str(tmp_path / ".jax_cache")
        assert cache.compilation_cache_dir() == want
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cache.setup_compilation_cache() == want
        assert os.path.isdir(want)
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_default_cache_dir_is_fixed_inside_checkout(monkeypatch, tmp_path):
    from stereo_vo.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    # a directory that cannot be made is an error, not a silent "no cache"
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocker / "sub"))
    with pytest.raises(OSError):
        cache.setup_compilation_cache()


def test_chip_smoke_fails_without_gpu():
    """The device check stops the script before anything compiles."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout
    assert "[b]" not in out.stdout


def test_svo_run_platform_gpu_fails_without_gpu(tmp_path):
    from stereo_vo import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["run", "--platform", "gpu", "--config", "kitti00",
                  "--synthetic", "3", "--out", str(tmp_path)])
    assert exc.value.code not in (0, None)
    assert not os.listdir(tmp_path)
