"""Per-task/actor runtime environments.

Reference parity: _private/runtime_env/ — the plugin framework
(plugin.py), working_dir/py_modules packaging (working_dir.py: zip to the
GCS KV store, extracted per node by the runtime-env agent,
agent/runtime_env_agent.py:164), and the dedicated-worker matching of
raylet's worker pool (worker_pool.h: workers are keyed by runtime-env
hash and never shared across envs).

TPU-first reductions, by design:
  - blobs travel over the control plane into a head-side registry (the
    function-registry mechanism) and are shipped to a worker once, at its
    first task with that env — same role as the reference's KV-store
    upload + per-node agent download, without a separate agent daemon;
  - workers are *dedicated*: a worker that applied env E only ever runs
    tasks with env E (matching the reference's pool semantics), so
    env_vars / cwd / sys.path can be applied process-wide;
  - ``pip`` / ``uv`` create a node-shared VENV per package list
    (``--system-site-packages``, reference: _private/runtime_env/pip.py,
    uv.py) and the dedicated worker puts its site-packages first on
    sys.path. The venv shares the worker's interpreter — package
    isolation, not interpreter swap, exactly the reference pip plugin's
    model (conda is the interpreter-swapping one);
  - ``conda`` / ``container`` are rejected up front: one interpreter and
    no container runtime in this image — a clear error beats a silent
    no-op.

Supported keys: ``env_vars`` (dict str→str), ``working_dir`` (local dir
path, zipped at submission), ``py_modules`` (list of local dirs/files put
on sys.path), ``pip`` / ``uv`` (list of requirement strings, or
{"packages": [...], "pip_install_options": [...]}), ``config`` (ignored
passthrough for API compat).
"""
from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile

_UNSUPPORTED = ("conda", "container", "image_uri", "java_jars", "nsight")
_SUPPORTED = ("env_vars", "working_dir", "py_modules", "pip", "uv",
              "config")

# driver-side cache: fingerprint of (relpath, mtime_ns, size) per file ->
# (content_hash, zip_bytes). Keying on content metadata (not just the
# path) means editing a file and resubmitting ships the NEW code — the
# fingerprint walk is cheap, the zip isn't.
_pack_cache: dict[str, tuple[str, bytes]] = {}


def _fingerprint(path: str) -> str:
    entries = []
    if os.path.isfile(path):
        st = os.stat(path)
        entries.append((os.path.basename(path), st.st_mtime_ns, st.st_size))
    else:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in
                             ("__pycache__", ".git", ".venv"))
            for fn in sorted(files):
                full = os.path.join(root, fn)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append((os.path.relpath(full, path),
                                st.st_mtime_ns, st.st_size))
    return hashlib.sha256(repr((path, entries)).encode()).hexdigest()


def validate(renv: dict) -> None:
    for k in renv:
        if k in _UNSUPPORTED:
            raise ValueError(
                f"runtime_env[{k!r}] is not supported on this runtime "
                f"(one interpreter, no container runtime); use pip/uv "
                f"envs, bake deps into the image, or vendor them via "
                f"py_modules")
        if k not in _SUPPORTED:
            raise ValueError(f"unknown runtime_env key {k!r}; supported: "
                             f"{_SUPPORTED}")
    ev = renv.get("env_vars", {})
    if not all(isinstance(k, str) and isinstance(v, str)
               for k, v in ev.items()):
        raise TypeError("runtime_env['env_vars'] must be dict[str, str]")
    if "pip" in renv and "uv" in renv:
        raise ValueError(
            "runtime_env cannot carry both 'pip' and 'uv' (one package "
            "provider per env; the reference rejects this too)")
    for key in ("pip", "uv"):
        if key in renv:
            _normalize_pip(renv[key], key)   # raises on bad shapes


def _normalize_pip(value, key: str) -> dict:
    """list[str] | {"packages": [...], "pip_install_options": [...]} ->
    {"packages": [...], "options": [...]}."""
    if isinstance(value, (list, tuple)):
        pkgs, opts = list(value), []
    elif isinstance(value, dict):
        pkgs = list(value.get("packages", []))
        opts = list(value.get("pip_install_options", []))
        unknown = set(value) - {"packages", "pip_install_options"}
        if unknown:
            raise ValueError(
                f"runtime_env[{key!r}] unknown fields {sorted(unknown)}")
    else:
        raise TypeError(
            f"runtime_env[{key!r}] must be a list of requirements or "
            f'{{"packages": [...], "pip_install_options": [...]}}')
    if not pkgs:
        raise ValueError(f"runtime_env[{key!r}] needs at least one package")
    if not all(isinstance(p, str) for p in pkgs + opts):
        raise TypeError(f"runtime_env[{key!r}] entries must be strings")
    return {"packages": pkgs, "options": opts}


def _zip_path(path: str) -> bytes:
    """Deterministic zip of a dir or single file (stable hash for caching)."""
    buf = io.BytesIO()
    path = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        if os.path.isfile(path):
            zi = zipfile.ZipInfo(os.path.basename(path))
            zi.compress_type = zipfile.ZIP_DEFLATED
            with open(path, "rb") as f:
                z.writestr(zi, f.read())
        else:
            entries = []
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in
                                 ("__pycache__", ".git", ".venv"))
                for fn in sorted(files):
                    full = os.path.join(root, fn)
                    entries.append((os.path.relpath(full, path), full))
            for rel, full in sorted(entries):
                zi = zipfile.ZipInfo(rel)  # fixed date -> deterministic
                zi.compress_type = zipfile.ZIP_DEFLATED
                with open(full, "rb") as f:
                    z.writestr(zi, f.read())
    return buf.getvalue()


def _pack(path: str) -> tuple[str, bytes]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"runtime_env path {path!r} does not exist")
    path = os.path.abspath(path)
    key = _fingerprint(path)
    cached = _pack_cache.get(key)
    if cached is None:
        blob = _zip_path(path)
        h = hashlib.sha256(blob).hexdigest()[:16]
        if len(_pack_cache) > 64:  # bound memory across many env versions
            _pack_cache.clear()
        cached = _pack_cache[key] = (h, blob)
    return cached


def prepare(renv: dict, register_blob) -> dict:
    """Driver-side: validate, zip local paths, register blobs with the head
    via ``register_blob(hash, bytes)``. Returns the wire-form env spec
    (hashes instead of paths) with a deterministic overall ``hash``."""
    validate(renv)
    spec: dict = {}
    if renv.get("env_vars"):
        spec["env_vars"] = dict(renv["env_vars"])
    if renv.get("working_dir"):
        h, blob = _pack(renv["working_dir"])
        register_blob(h, blob)
        spec["working_dir"] = h
    if renv.get("py_modules"):
        hashes = []
        for p in renv["py_modules"]:
            h, blob = _pack(p)
            register_blob(h, blob)
            hashes.append(h)
        spec["py_modules"] = hashes
    for key in ("pip", "uv"):
        if renv.get(key):
            spec["pip"] = _normalize_pip(renv[key], key)
            break   # uv is the same venv backend with a different frontend
    if not spec:
        return {}
    import json
    # sort_keys canonicalizes nested dicts too — env_vars insertion order
    # must not fork dedicated-worker pools
    digest = hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()
    spec["hash"] = digest[:16]
    return spec


def env_hash(spec: dict | None) -> str | None:
    return spec.get("hash") if spec else None


def apply_in_worker(spec: dict, blobs: dict[str, bytes],
                    base_dir: str) -> None:
    """Worker-side: materialize the env in THIS process (the worker is
    dedicated to it). env_vars -> os.environ; working_dir -> extract,
    chdir, sys.path[0]; py_modules -> extract, sys.path."""
    for k, v in spec.get("env_vars", {}).items():
        os.environ[k] = v
    for h in spec.get("py_modules", []):
        d = _extract(blobs[h], os.path.join(base_dir, h))
        if d not in sys.path:
            sys.path.insert(0, d)
    wd = spec.get("working_dir")
    if wd is not None:
        d = _extract(blobs[wd], os.path.join(base_dir, wd))
        os.chdir(d)
        if d not in sys.path:
            sys.path.insert(0, d)
    if spec.get("pip"):
        _activate_venv(_ensure_venv(spec["pip"], base_dir))


def _ensure_venv(pip_spec: dict, base_dir: str,
                 timeout_s: float = 300.0) -> str:
    """Create (once per node, race-guarded) the venv for this package
    list; returns its directory. --system-site-packages keeps the image's
    baked deps visible, matching the reference pip plugin's default."""
    import json
    import subprocess
    import time

    key = hashlib.sha256(
        json.dumps(pip_spec, sort_keys=True).encode()).hexdigest()[:16]
    venv_dir = os.path.join(base_dir, f"venv-{key}")
    done = os.path.join(venv_dir, ".rtpu_done")
    if os.path.exists(done):
        return venv_dir
    os.makedirs(base_dir, exist_ok=True)
    lock = venv_dir + ".lock"
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            os.makedirs(lock)
            with open(os.path.join(lock, "pid"), "w") as f:
                f.write(str(os.getpid()))
            break   # we own creation
        except FileExistsError:
            if os.path.exists(done):
                return venv_dir   # another worker finished it
            # stale lock? a worker killed mid-install (OOM, SIGKILL)
            # leaves the lock with no finally — reclaim when its pid is
            # gone so one crash can't wedge the env node-wide
            try:
                with open(os.path.join(lock, "pid")) as f:
                    owner = int(f.read().strip() or 0)
            except (OSError, ValueError):
                owner = None   # racing its creation: give it a beat
            if owner:
                try:
                    os.kill(owner, 0)
                except ProcessLookupError:
                    import shutil
                    shutil.rmtree(venv_dir, ignore_errors=True)
                    shutil.rmtree(lock, ignore_errors=True)
                    continue   # retake the lock
                except PermissionError:
                    pass       # alive under another uid: keep waiting
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"venv {venv_dir} creation stuck behind {lock}")
            time.sleep(0.2)
    try:
        if os.path.exists(done):
            return venv_dir
        r = subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages",
             venv_dir],
            capture_output=True, text=True, timeout=timeout_s)
        if r.returncode:
            raise RuntimeError(f"venv creation failed:\n{r.stderr[-2000:]}")
        cmd = [os.path.join(venv_dir, "bin", "python"), "-m", "pip",
               "install", *pip_spec.get("options", []),
               *pip_spec["packages"]]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s)
        if r.returncode:
            raise RuntimeError(
                f"pip install failed ({' '.join(cmd)}):\n"
                f"{r.stderr[-2000:]}")
        with open(done, "w") as f:
            f.write("ok")
        return venv_dir
    finally:
        import shutil
        shutil.rmtree(lock, ignore_errors=True)


def _activate_venv(venv_dir: str) -> None:
    """Put the venv's site-packages FIRST on sys.path and its bin on PATH.
    Same interpreter (venv shares this CPython): package isolation, not
    interpreter swap — the reference pip plugin's model."""
    import glob
    sps = glob.glob(os.path.join(venv_dir, "lib", "python*",
                                 "site-packages"))
    if not sps:
        raise RuntimeError(f"no site-packages under {venv_dir}")
    if sps[0] not in sys.path:
        sys.path.insert(0, sps[0])
    os.environ["VIRTUAL_ENV"] = venv_dir
    os.environ["PATH"] = (os.path.join(venv_dir, "bin") + os.pathsep
                          + os.environ.get("PATH", ""))


def _extract(blob: bytes, dest: str) -> str:
    dest = os.path.abspath(dest)
    if not os.path.isdir(dest):
        tmp = dest + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            for name in z.namelist():  # zip-slip guard
                target = os.path.abspath(os.path.join(tmp, name))
                if not target.startswith(tmp + os.sep) and target != tmp:
                    raise ValueError(f"zip entry escapes dest: {name!r}")
            z.extractall(tmp)
        try:
            os.rename(tmp, dest)  # atomic: concurrent workers race safely
        except OSError:
            if not os.path.isdir(dest):
                raise
    return dest
