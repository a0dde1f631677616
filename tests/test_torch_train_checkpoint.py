"""The port's Train checkpoints and storage helpers, without a runtime.

``ray_tpu_torch.train.checkpoint`` and ``ray_tpu_torch.util.fs``
against the reference's: the checkpoint and filesystem cases of
``tests/test_cloud_io.py`` (resolver, gs:// handle, globbing, file://
round trip, a non-local filesystem's download, the manager on a URI,
streamed tree copies) pointed at the port, with tensors where the
reference has numpy arrays; the reference's orbax pair
(``tests/test_train.py``, marked slow there as here) as the port's
``torch.distributed.checkpoint`` pair; ``from_state`` / ``load_state``
round trips (bitwise for every dtype); both packages'
``CheckpointManager`` over the same registrations; and a local-path
checkpoint in a process where pyarrow cannot be imported.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu import train as ref_train
from ray_tpu.util import fs as ref_fs
from ray_tpu_torch import train as rtrain
from ray_tpu_torch.util import fs as fsutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- resolver and listings (tests/test_cloud_io.py:28, :44, :54) -----------

def test_resolve_schemes(tmp_path):
    from pyarrow import fs as pafs
    f, p = fsutil.resolve(str(tmp_path))
    assert fsutil.is_local(f) and p == str(tmp_path)
    f, p = fsutil.resolve(f"file://{tmp_path}")
    assert fsutil.is_local(f) and p == str(tmp_path)
    # gs:// and s3:// resolve offline (no network round-trip)
    f, p = fsutil.resolve("gs://bucket/some/key")
    assert type(f).__name__ == "GcsFileSystem" and p == "bucket/some/key"
    f, p = fsutil.resolve("s3://bucket/some/key")
    assert type(f).__name__ == "S3FileSystem" and p == "bucket/some/key"
    # explicit filesystem wins; URI scheme is stripped for it
    f2, p2 = fsutil.resolve("gs://bucket/k", filesystem=pafs.LocalFileSystem())
    assert isinstance(f2, pafs.LocalFileSystem) and p2 == "bucket/k"
    assert fsutil.is_local(f2)


def test_gs_uri_accepted_end_to_end():
    ck = rtrain.Checkpoint("gs://bucket/ckpt")
    assert type(ck.filesystem).__name__ == "GcsFileSystem"
    assert ck.path == "gs://bucket/ckpt"


def _data_tree(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    for i in range(3):
        (d / f"f{i}.csv").write_text("a,b\n1,2\n")
    (d / "nested").mkdir()
    (d / "nested" / "g.csv").write_text("a,b\n3,4\n")
    (d / "nested" / "f9.csv").write_text("a,b\n5,6\n")
    (d / "nested" / "deeper").mkdir()
    (d / "nested" / "deeper" / "f5.csv").write_text("a,b\n7,8\n")
    return d


def test_expand_paths_glob_dir_mix(tmp_path):
    d = _data_tree(tmp_path)
    (d / "nested" / "deeper" / "f5.csv").unlink()
    (d / "nested" / "deeper").rmdir()
    fs_, files = fsutil.expand_paths(str(d))
    assert len(files) == 5  # recursive dir listing
    # glob.glob semantics: '*' does not cross '/' (nested/f9.csv excluded)
    fs_, files = fsutil.expand_paths(str(d / "f*.csv"))
    assert len(files) == 3
    # '**' recurses; one-level dir glob expands segment-wise
    fs_, files = fsutil.expand_paths(str(d / "**" / "f*.csv"))
    assert len(files) == 4
    fs_, files = fsutil.expand_paths(str(d / "*" / "*.csv"))
    assert len(files) == 2
    fs_, files = fsutil.expand_paths([str(d / "f0.csv"), str(d / "f1.csv")])
    assert len(files) == 2
    with pytest.raises(FileNotFoundError):
        fsutil.expand_paths(str(d / "nope*.csv"))


@pytest.mark.parametrize("pattern", [
    "", "f*.csv", "**/f*.csv", "*/*.csv", "**/*.csv", "nested/*",
    "*/deeper/f?.csv", "[fg]*.csv", "f0.csv/*"])
def test_listings_equal_the_reference(tmp_path, pattern):
    """expand_paths / list_files / list_dirs / glob_files over local paths
    (served through os here, through pyarrow there) give the reference's
    paths, in the reference's order."""
    d = _data_tree(tmp_path)
    p = str(d / pattern) if pattern else str(d)
    ref_f, _ = ref_fs.resolve(p)
    f, fp = fsutil.resolve(p)
    if "*" in pattern or "?" in pattern or "[" in pattern:
        assert fsutil.glob_files(f, fp) == ref_fs.glob_files(ref_f, fp)
    for base in (str(d), str(d / "nested"), str(d / "missing")):
        assert fsutil.list_files(fsutil.LOCAL, base) == ref_fs.list_files(
            ref_f, base)
        assert fsutil.list_dirs(fsutil.LOCAL, base) == ref_fs.list_dirs(
            ref_f, base)
    try:
        want = ref_fs.expand_paths(p)[1]
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            fsutil.expand_paths(p)
    else:
        assert fsutil.expand_paths(p)[1] == want


# -- checkpoints on filesystem URIs (tests/test_cloud_io.py:117-175) -------

def test_checkpoint_roundtrip_file_uri(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "step": 7}
    uri = f"file://{tmp_path}/ck1"
    ck = rtrain.Checkpoint.from_state(state, uri, metadata={"epoch": 3})
    assert ck.metadata() == {"epoch": 3}
    back = ck.load_state(target={"w": torch.zeros(2, 3), "step": 0})
    assert torch.equal(back["w"], state["w"])
    assert back["step"] == 7
    # handle survives pickling with its URI intact
    ck2 = pickle.loads(pickle.dumps(ck))
    assert ck2.metadata() == {"epoch": 3}
    assert ck2.path == uri and ck2.as_directory() == str(tmp_path / "ck1")


def test_checkpoint_as_directory_downloads_remote(tmp_path):
    """A checkpoint on a non-local filesystem materializes locally via
    as_directory (SubTree stands in for a cloud fs)."""
    from pyarrow import fs as pafs
    root = tmp_path / "remote"
    root.mkdir()
    fs_ = pafs.SubTreeFileSystem(str(root), pafs.LocalFileSystem())
    state = {"b": torch.ones(4)}
    ck = rtrain.Checkpoint.from_state(state, "ck", filesystem=fs_)
    assert (root / "ck" / "state.pt").exists()
    d = ck.as_directory()
    assert d != str(root / "ck")
    assert os.path.exists(os.path.join(d, "state.pt"))
    back = ck.load_state(target={"b": torch.zeros(4)})
    assert torch.equal(back["b"], state["b"])
    out = ck.to_directory(str(tmp_path / "copy"))
    assert sorted(os.listdir(out)) == ["state.pt"]


def test_checkpoint_manager_on_uri(tmp_path):
    store = f"file://{tmp_path}/managed"
    mgr = rtrain.CheckpointManager(store, num_to_keep=2,
                                   score_attribute="acc")
    for i in range(4):
        src = rtrain.Checkpoint.from_state(
            {"i": torch.tensor([i])}, str(tmp_path / f"src{i}"))
        mgr.register(src, {"acc": float(i)})
    kept = os.listdir(tmp_path / "managed")
    assert len(kept) == 2  # pruned to num_to_keep (latest==best here)
    assert mgr.best is mgr.latest
    back = mgr.latest.load_state(target={"i": torch.zeros(1,
                                                          dtype=torch.int64)})
    assert int(back["i"][0]) == 3


@pytest.mark.parametrize("pyarrow_side", ["src", "dst", "neither"])
def test_copy_tree_streams(tmp_path, pyarrow_side):
    from pyarrow import fs as pafs
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"x" * 1000)
    (src / "sub" / "b.bin").write_bytes(b"y" * (fsutil._COPY_CHUNK + 7))
    lfs = pafs.LocalFileSystem()
    src_fs = lfs if pyarrow_side == "src" else fsutil.LOCAL
    dst_fs = lfs if pyarrow_side == "dst" else fsutil.LOCAL
    dst = tmp_path / "dst"
    fsutil.copy_tree(src_fs, str(src), dst_fs, str(dst))
    assert (dst / "a.bin").read_bytes() == b"x" * 1000
    assert (dst / "sub" / "b.bin").read_bytes() == b"y" * (
        fsutil._COPY_CHUNK + 7)


# -- the torch.distributed.checkpoint pair (the reference's orbax cases,
#    tests/test_train.py:229 and :268, slow there) -------------------------

@pytest.mark.slow
def test_dcp_checkpoint_roundtrip(tmp_path):
    state = {
        "w": torch.arange(64.0).reshape(8, 8),
        "h": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
        "step": 7,
        "nested": {"b": torch.ones(3), 0: torch.tensor([5])},
    }
    ckpt = rtrain.Checkpoint.from_state_dcp(
        state, str(tmp_path / "ck"), metadata={"iter": 7})
    assert ckpt.has_dcp_state()
    assert ckpt.metadata() == {"iter": 7}

    # structural restore (no target)
    raw = ckpt.load_state_dcp()
    assert torch.equal(raw["w"], state["w"])
    assert raw["h"].dtype == torch.bfloat16 and torch.equal(raw["h"],
                                                           state["h"])
    assert raw["step"] == 7
    assert torch.equal(raw["nested"][0], torch.tensor([5]))

    # restore into a target: its tensors are filled in place
    target = {"w": torch.zeros(8, 8), "h": torch.zeros(3, 4,
                                                      dtype=torch.bfloat16),
              "step": 0, "nested": {"b": torch.zeros(3),
                                    0: torch.zeros(1, dtype=torch.int64)}}
    w = target["w"]
    restored = ckpt.load_state_dcp(target)
    assert restored["w"] is w and torch.equal(w, state["w"])
    assert restored["step"] == 7
    assert torch.equal(restored["nested"]["b"], torch.ones(3))


@pytest.mark.slow
def test_dcp_checkpoint_overwrites_fixed_path(tmp_path):
    d = str(tmp_path / "latest")
    rtrain.Checkpoint.from_state_dcp({"v": torch.tensor(1.0)}, d)
    ck = rtrain.Checkpoint.from_state_dcp({"v": torch.tensor(2.0)}, d)
    assert float(ck.load_state_dcp()["v"]) == 2.0


def test_dcp_refuses_a_non_local_filesystem(tmp_path):
    from pyarrow import fs as pafs
    fs_ = pafs.SubTreeFileSystem(str(tmp_path), pafs.LocalFileSystem())
    ck = rtrain.Checkpoint("ck", filesystem=fs_)
    with pytest.raises(ValueError, match="local paths"):
        ck.load_state_dcp()
    assert not rtrain.Checkpoint(str(tmp_path)).has_dcp_state()


# -- from_state / load_state ------------------------------------------------

def _state():
    g = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(5, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.0)
    model(torch.randn(2, 5, generator=g)).sum().backward()
    opt.step()
    return {
        "params": {"wq": torch.randn(4, 6, generator=g).to(torch.bfloat16),
                   "norm": torch.randn(6, generator=g),
                   "ids": torch.randint(-9, 9, (5,), dtype=torch.int32,
                                        generator=g),
                   "layers": [{"w": torch.randn(2, 2, generator=g)},
                              {"w": torch.randn(2, 2, generator=g)}]},
        "opt": opt.state_dict(),
        "step": 2, "name": "run", "lr": 3e-4, "flag": True, "none": None,
    }


def _assert_bitwise(a, b, where=()):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_bitwise(a[k], b[k], where + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, where + (i,))
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b), where
    else:
        assert a == b, where


def test_from_state_load_state_bitwise(tmp_path):
    state = _state()
    ck = rtrain.Checkpoint.from_state(state, str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path / "ck")) == ["state.pt"]
    assert ck.metadata() == {}
    _assert_bitwise(ck.load_state(), state)


def test_load_state_into_target_structure_dtype_and_device(tmp_path):
    state = _state()
    ck = rtrain.Checkpoint.from_state(state, str(tmp_path / "ck"))
    target = _state()
    target["params"]["norm"] = torch.zeros(6, dtype=torch.float64)
    target["params"]["wq"] = torch.zeros(4, 6, dtype=torch.bfloat16,
                                         device="meta")
    back = ck.load_state(target)
    assert back["params"]["norm"].dtype == torch.float64
    torch.testing.assert_close(back["params"]["norm"],
                               state["params"]["norm"].double())
    assert back["params"]["wq"].device.type == "meta"
    _assert_bitwise(back["params"]["layers"], state["params"]["layers"])
    _assert_bitwise(back["opt"], state["opt"])
    # an optimizer restored from the loaded state_dict steps as the original
    model = torch.nn.Linear(5, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.0)
    opt.load_state_dict(back["opt"])
    assert opt.state_dict()["state"][0]["step"] == 1
    bad = dict(target, extra=1)
    with pytest.raises(ValueError, match="keys"):
        ck.load_state(bad)


def test_from_state_takes_numpy_arrays(tmp_path):
    state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "i": 4}
    ck = rtrain.Checkpoint.from_state(state, str(tmp_path / "ck"))
    assert torch.equal(ck.load_state()["a"], torch.arange(6.0).reshape(2, 3))
    back = ck.load_state(target={"a": np.zeros((2, 3), np.float64), "i": 0})
    assert back["a"].dtype == np.float64
    np.testing.assert_array_equal(back["a"], state["a"])


# -- CheckpointManager against the reference's ------------------------------

_SEQUENCES = {
    "keep_all": dict(num_to_keep=None, score_attribute=None),
    "keep_2_max": dict(num_to_keep=2, score_attribute="acc",
                       score_order="max"),
    "keep_1_min": dict(num_to_keep=1, score_attribute="loss",
                       score_order="min"),
    "keep_2_unscored": dict(num_to_keep=2, score_attribute="missing"),
}
_METRICS = [{"acc": 0.5, "loss": 3.0}, {"acc": 0.9, "loss": 1.0},
            {"acc": 0.2, "loss": 2.0}, {"acc": 0.7, "loss": 0.5},
            {"acc": 0.1, "loss": 4.0}]


@pytest.mark.parametrize("case", sorted(_SEQUENCES))
def test_checkpoint_manager_matches_reference(tmp_path, case):
    """The same registrations (each package's own from_state, with
    metadata) keep the same directories and pick the same latest and
    best in both packages; scan_existing over the kept directories, one
    with a truncated _metadata.json, finds the same count and latest."""
    kept, picks, scans = {}, {}, {}
    for pkg, mod in (("ref", ref_train), ("port", rtrain)):
        root = tmp_path / pkg
        mgr = mod.CheckpointManager(str(root / "managed"), **_SEQUENCES[case])
        for i, m in enumerate(_METRICS):
            src = mod.Checkpoint.from_state(
                {"i": i}, str(root / f"src{i}"), metadata={"i": i, **m})
            mgr.register(src, m)
        kept[pkg] = sorted(os.listdir(root / "managed"))
        picks[pkg] = (os.path.basename(mgr.latest.path),
                      os.path.basename(mgr.best.path),
                      [os.path.basename(c.path) for c, _ in mgr.history],
                      [m for _, m in mgr.history])
        (root / "managed" / kept[pkg][-1] / "_metadata.json").write_text(
            '{"i": ')
        (root / "managed" / "not_a_checkpoint").mkdir()
        again = mod.CheckpointManager(str(root / "managed"),
                                      **_SEQUENCES[case])
        n = again.scan_existing()
        scans[pkg] = (n, os.path.basename(again.latest.path),
                      [m for _, m in again.history], again._seq)
    assert kept["port"] == kept["ref"]
    assert picks["port"] == picks["ref"]
    assert scans["port"] == scans["ref"]
    assert scans["port"][2][-1] == {}        # the truncated metadata


# -- local checkpoints without pyarrow ---------------------------------------

_NO_PYARROW = r"""
import json, os, sys
sys.modules["pyarrow"] = None          # any import of pyarrow now fails
import torch
from ray_tpu_torch import train
from ray_tpu_torch.util import fs as fsutil
d = sys.argv[1]
state = {"w": torch.arange(4, dtype=torch.bfloat16), "step": 3}
ck = train.Checkpoint.from_state(state, os.path.join(d, "src"),
                                 metadata={"step": 3})
back = ck.load_state(target={"w": torch.zeros(4, dtype=torch.bfloat16),
                             "step": 0})
assert torch.equal(back["w"], state["w"]) and back["step"] == 3
uri = train.Checkpoint.from_state(state, "file://" + os.path.join(d, "u"))
assert uri.load_state()["step"] == 3 and uri.as_directory().startswith("/")
copy = ck.to_directory(os.path.join(d, "copy"))
mgr = train.CheckpointManager(os.path.join(d, "managed"), num_to_keep=1)
mgr.register(ck, {"step": 3})
mgr.register(train.Checkpoint.from_directory(copy), {"step": 4})
again = train.CheckpointManager(os.path.join(d, "managed"))
print(json.dumps({
    "copy": sorted(os.listdir(copy)),
    "managed": sorted(os.listdir(os.path.join(d, "managed"))),
    "files": [os.path.relpath(p, d) for p in
              fsutil.list_files(fsutil.LOCAL, os.path.join(d, "managed"))],
    "glob": [os.path.relpath(p, d) for p in
             fsutil.expand_paths(os.path.join(d, "*", "*.pt"))[1]],
    "scan": again.scan_existing(),
    "latest_step": again.latest.load_state()["step"],
    "meta": train.Checkpoint(copy).metadata(),
    "pyarrow": sys.modules["pyarrow"]}))
"""


def test_local_checkpoints_work_without_pyarrow(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_PYARROW, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {
        "copy": ["_metadata.json", "state.pt"],
        "managed": ["checkpoint_000001"],
        "files": ["managed/checkpoint_000001/_metadata.json",
                  "managed/checkpoint_000001/state.pt"],
        "glob": ["copy/state.pt", "src/state.pt", "u/state.pt"],
        "scan": 1, "latest_step": 3, "meta": {"step": 3},
        "pyarrow": None}
