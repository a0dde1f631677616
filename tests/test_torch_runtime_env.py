"""Runtime environment tests (reference: _private/runtime_env/).

The port's copy of ``tests/test_runtime_env.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.
"""
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import runtime_env as renv_mod


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


@pytest.fixture
def ray(ray_start_regular):
    return ray_start_regular


def test_validate_rejects_conda_and_unknown():
    # pip/uv became a real backend (test_runtime_env_pip.py); the
    # no-interpreter-swap keys still refuse loudly
    with pytest.raises(ValueError, match="not supported"):
        renv_mod.validate({"conda": {"dependencies": ["x"]}})
    with pytest.raises(ValueError, match="not supported"):
        renv_mod.validate({"container": {"image": "x"}})
    with pytest.raises(ValueError, match="unknown"):
        renv_mod.validate({"bogus_key": 1})
    with pytest.raises(TypeError):
        renv_mod.validate({"env_vars": {"A": 1}})


def test_prepare_is_deterministic(tmp_path):
    d = tmp_path / "mod"
    d.mkdir()
    (d / "x.py").write_text("V = 5\n")
    blobs = {}
    s1 = renv_mod.prepare({"working_dir": str(d)}, blobs.__setitem__)
    s2 = renv_mod.prepare({"working_dir": str(d)}, blobs.__setitem__)
    assert s1["hash"] == s2["hash"]
    assert s1["working_dir"] in blobs


def test_env_vars_applied_in_dedicated_worker(ray):
    @ray.remote(runtime_env={"env_vars": {"MY_RENV_FLAG": "hello42"}})
    def read_flag():
        return os.environ.get("MY_RENV_FLAG")

    @ray.remote
    def read_plain():
        return os.environ.get("MY_RENV_FLAG")

    assert ray.get(read_flag.remote(), timeout=60) == "hello42"
    # plain tasks must NOT land on the dedicated worker
    assert ray.get(read_plain.remote(), timeout=60) is None


def test_working_dir_and_py_modules(ray, tmp_path):
    wd = tmp_path / "appdir"
    wd.mkdir()
    (wd / "data.txt").write_text("payload!")
    mod = tmp_path / "extra_mod"
    mod.mkdir()
    (mod / "extra_lib.py").write_text("ANSWER = 99\n")

    @ray.remote(runtime_env={"working_dir": str(wd),
                             "py_modules": [str(mod)]})
    def use_env():
        import extra_lib
        with open("data.txt") as f:
            return f.read(), extra_lib.ANSWER

    data, ans = ray.get(use_env.remote(), timeout=60)
    assert data == "payload!"
    assert ans == 99


def test_actor_runtime_env(ray):
    @ray.remote(runtime_env={"env_vars": {"ACTOR_RENV": "yes"}})
    class EnvActor:
        def flag(self):
            return os.environ.get("ACTOR_RENV")

    a = EnvActor.remote()
    assert ray.get(a.flag.remote(), timeout=60) == "yes"


def test_same_env_reuses_worker(ray):
    import time

    @ray.remote(runtime_env={"env_vars": {"REUSE_ME": "1"}})
    def whoami():
        return os.getpid()

    pids = set()
    for _ in range(3):
        pids.add(ray.get(whoami.remote(), timeout=60))
        time.sleep(0.5)  # let the done message release the worker to idle
    assert len(pids) == 1, pids  # sequential calls reuse the dedicated worker


def test_bad_working_dir_fails_cleanly(ray):
    with pytest.raises(FileNotFoundError):
        @ray.remote(runtime_env={"working_dir": "/nonexistent/dir/xyz"})
        def f():
            return 1
        f.remote()
