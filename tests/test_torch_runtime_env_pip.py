"""pip/uv runtime-env backend: node-shared venv per package list
(reference: _private/runtime_env/pip.py, uv.py). Offline-testable via a
local source package installed with --no-index --no-build-isolation.

The port's copy of ``tests/test_runtime_env_pip.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` fixture is the port's own, defined here under
the reference's name: ``tests/conftest.py``'s start the reference's
runtime.

Every case is marked ``slow``, as in the reference.
"""
import os
import textwrap

import pytest

import ray_tpu_torch


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()

# every test here builds/installs a venv — inherently tens of seconds and
# exercised by the runtime-env unit tests in tier-1's budget's stead
pytestmark = pytest.mark.slow


@pytest.fixture
def ray(ray_start_regular):
    return ray_start_regular


@pytest.fixture
def local_pkg(tmp_path_factory):
    """A minimal installable source package (no network, no build
    isolation — system setuptools builds it)."""
    root = tmp_path_factory.mktemp("rtpu_pkg")
    (root / "rtpu_env_probe.py").write_text("MAGIC = 20260730\n")
    (root / "setup.py").write_text(textwrap.dedent("""\
        from setuptools import setup
        setup(name="rtpu-env-probe", version="0.1",
              py_modules=["rtpu_env_probe"])
    """))
    return str(root)


OFFLINE = ["--no-index", "--no-build-isolation"]


def test_pip_env_installs_and_isolates(ray, local_pkg):
    with pytest.raises(ImportError):
        import rtpu_env_probe  # noqa: F401 — not in the driver's env

    @ray.remote(runtime_env={"pip": {"packages": [local_pkg],
                                     "pip_install_options": OFFLINE}})
    def probe():
        import rtpu_env_probe
        return rtpu_env_probe.MAGIC, os.environ.get("VIRTUAL_ENV", "")

    magic, venv = ray.get(probe.remote(), timeout=300)
    assert magic == 20260730
    assert "venv-" in venv

    # second task, same env: the dedicated worker (and node-shared venv)
    # serve it without reinstalling
    assert ray.get(probe.remote(), timeout=120)[0] == 20260730


def test_uv_key_maps_to_same_backend(ray, local_pkg):
    @ray.remote(runtime_env={"uv": {"packages": [local_pkg],
                                    "pip_install_options": OFFLINE}})
    def probe():
        import rtpu_env_probe
        return rtpu_env_probe.MAGIC

    assert ray.get(probe.remote(), timeout=300) == 20260730


def test_pip_env_failure_is_loud(ray):
    @ray.remote(runtime_env={"pip": {
        "packages": ["definitely-not-a-package-xyz"],
        "pip_install_options": ["--no-index"]}})
    def probe():
        return 1

    with pytest.raises(Exception, match="pip install failed"):
        ray.get(probe.remote(), timeout=300)


def test_validation():
    from ray_tpu_torch.core.runtime_env import validate
    with pytest.raises(ValueError, match="at least one package"):
        validate({"pip": []})
    with pytest.raises(TypeError, match="list of requirements"):
        validate({"pip": "numpy"})
    with pytest.raises(ValueError, match="not supported"):
        validate({"conda": {"dependencies": ["x"]}})
    validate({"pip": ["numpy"]})   # ok
    validate({"uv": {"packages": ["numpy"],
                     "pip_install_options": ["--no-index"]}})
