"""Checkpoints: storage handles, state helpers and the manager.

The port's copy of ``ray_tpu/train/checkpoint.py`` (reference parity:
python/ray/train/_checkpoint.py:56 — Checkpoint, "a directory on local
or remote (e.g. cloud) storage" — and train/v2/_internal/execution/
checkpoint/checkpoint_manager.py: latest/best tracking, num_to_keep
pruning). The layout and the API are the reference's; paths may be
local, ``file://``, or ``gs://``/``s3://`` URIs (``util/fs.py``), and a
local path needs no pyarrow.

What differs: model state is a nested dict of tensors and Python values
(params, an optimizer's ``state_dict()``, a step), so ``from_state`` /
``load_state`` write it with ``torch.save`` and read it with
``torch.load(weights_only=True, map_location="cpu")`` where the
reference uses flax msgpack; tensors, bf16 included, come back bitwise.
The reference's orbax pair (sharded pytrees, each host writing its own
shards) becomes a ``torch.distributed.checkpoint`` pair with the same
roles: ``from_state_dcp`` / ``load_state_dcp`` / ``has_dcp_state``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

from ..util import fs as fsutil

_STATE_FILE = "state.pt"
_METADATA_FILE = "_metadata.json"


class Checkpoint:
    """Handle on a checkpoint directory — local path or storage URI
    (reference: _checkpoint.py:56)."""

    def __init__(self, path: str, filesystem=None):
        self.path = path if (filesystem is not None or fsutil.is_uri(path)) \
            else os.path.abspath(path)
        self._filesystem = filesystem
        self._local_cache: Optional[str] = None

    def _resolved(self):
        return fsutil.resolve(self.path, self._filesystem)

    @property
    def filesystem(self):
        return self._resolved()[0]

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str, filesystem=None) -> "Checkpoint":
        return cls(uri, filesystem=filesystem)

    def as_directory(self) -> str:
        """A local directory view: the path itself when local, otherwise a
        one-time download (cached for the handle's lifetime)."""
        fs_, p = self._resolved()
        if fsutil.is_local(fs_):
            return p
        if self._local_cache is None:
            self._local_cache = fsutil.download_dir(fs_, p)
        return self._local_cache

    def to_directory(self, path: Optional[str] = None) -> str:
        dst = os.path.abspath(path or tempfile.mkdtemp(prefix="rtpu_ckpt_"))
        fs_, p = self._resolved()
        if not (fsutil.is_local(fs_) and p == dst):
            fsutil.copy_tree(fs_, p, fsutil.LOCAL, dst)
        return dst

    # -- state helpers -----------------------------------------------------

    @classmethod
    def from_state(cls, state: Any, path: Optional[str] = None,
                   metadata: Optional[dict] = None,
                   filesystem=None) -> "Checkpoint":
        """Write a nested dict of tensors and Python values (params,
        optimizer ``state_dict()``, step...) to a new checkpoint directory
        (local or URI) with ``torch.save``. Tensors on a device are
        written from host copies; numpy arrays and numeric numpy
        scalars are stored as tensors."""
        import torch
        ckpt = cls(path or tempfile.mkdtemp(prefix="rtpu_ckpt_"),
                   filesystem=filesystem)
        fs_, d = ckpt._resolved()
        fsutil.makedirs(fs_, d)
        state = _map_leaves(state, _to_host)
        p = fsutil.join(d, _STATE_FILE)
        if isinstance(fs_, fsutil.LocalFS):
            torch.save(state, p)     # the C++ file writer: no Python writes
        else:
            with fsutil._open_output(fs_, p) as f:
                torch.save(state, f)
        if metadata is not None:
            fsutil.write_bytes(fs_, fsutil.join(d, _METADATA_FILE),
                               json.dumps(metadata).encode("utf-8"))
        return ckpt

    def load_state(self, target: Any = None) -> Any:
        """Restore the state: CPU tensors (mapped from the file when it is
        local, read only as they are touched). With ``target`` (a template
        of the same structure), restores into its structure, dtypes and
        devices; without, returns the tree as written."""
        import torch
        fs_, d = self._resolved()
        p = fsutil.join(d, _STATE_FILE)
        if isinstance(fs_, fsutil.LocalFS):
            state = torch.load(p, map_location="cpu", weights_only=True,
                               mmap=True)
        else:
            import io
            state = torch.load(io.BytesIO(fsutil.read_bytes(fs_, p)),
                               map_location="cpu", weights_only=True)
        if target is None:
            return state
        return _restore_into(target, state, ())

    # -- torch.distributed.checkpoint backend (sharded state) --------------

    _DCP_DIR = "dcp_state"
    _DCP_KEYS = "_dcp_keys.json"

    def _dcp_path(self) -> str:
        """The reference's ``_orbax_path``: torch.distributed.checkpoint's
        file-system writer takes local paths (and ``file://`` URIs); every
        other filesystem is refused rather than staged through a copy of a
        multi-host tree."""
        fs_, p = self._resolved()
        if isinstance(fs_, fsutil.LocalFS):
            return fsutil.join(p, self._DCP_DIR)
        raise ValueError(
            f"the torch.distributed.checkpoint backend supports local paths "
            f"and file:// URIs, got {self.path!r}"
            + (f" on an explicit {type(fs_).__name__}"
               if self._filesystem is not None else ""))

    @classmethod
    def from_state_dcp(cls, state: dict, path: Optional[str] = None,
                       metadata: Optional[dict] = None) -> "Checkpoint":
        """Write through ``torch.distributed.checkpoint`` (replaces the
        reference's ``from_state_orbax``): under an initialized process
        group each rank writes only ITS shards of a sharded tensor, so a
        multi-host checkpoint never gathers the whole state on one
        machine; without one, this process writes it all. Overwrites a
        fixed path, as the reference's ``force=True`` does."""
        import inspect

        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp
        group = dist.is_available() and dist.is_initialized()
        if path is None and group and dist.get_world_size() > 1:
            # every process must write into the SAME shared directory; a
            # per-host mkdtemp would diverge
            raise ValueError(
                "from_state_dcp needs an explicit shared-filesystem path "
                "when a process group spans several processes")
        ckpt = cls(path or tempfile.mkdtemp(prefix="rtpu_ckpt_"))
        dst = ckpt._dcp_path()
        os.makedirs(dst, exist_ok=True)
        flat = _flatten(state)
        overwrite = ({"overwrite": True} if "overwrite" in inspect.signature(
            dcp.FileSystemWriter).parameters else {})
        dcp.save({k: v for k, (_, v) in flat.items()},
                 storage_writer=dcp.FileSystemWriter(dst, **overwrite),
                 no_dist=not group)
        if not group or dist.get_rank() == 0:
            with open(os.path.join(dst, cls._DCP_KEYS), "w") as f:
                json.dump([path_ for path_, _ in flat.values()], f)
            if metadata is not None:
                fs_, d = ckpt._resolved()
                fsutil.write_bytes(fs_, fsutil.join(d, _METADATA_FILE),
                                   json.dumps(metadata).encode("utf-8"))
        return ckpt

    def load_state_dcp(self, target: Optional[dict] = None) -> dict:
        """Restore a ``from_state_dcp`` checkpoint (replaces the
        reference's ``load_state_orbax``). With ``target``, its tensors
        are filled in place (each on its own device and, for sharded
        tensors, with only its own shards: the multi-host resume path)
        and its structure is returned; without, tensors come back on the
        CPU with their saved shapes and dtypes."""
        import torch
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import \
            TensorStorageMetadata
        src = self._dcp_path()
        group = dist.is_available() and dist.is_initialized()
        reader = dcp.FileSystemReader(src)
        if target is not None:
            flat = _flatten(target)
        else:
            with open(os.path.join(src, self._DCP_KEYS)) as f:
                paths = [tuple(p) for p in json.load(f)]
            meta = reader.read_metadata().state_dict_metadata
            flat = {}
            for p in paths:
                m = meta[_fqn(p)]
                flat[_fqn(p)] = (p, torch.empty(
                    tuple(m.size), dtype=m.properties.dtype)
                    if isinstance(m, TensorStorageMetadata) else None)
        sd = {k: v for k, (_, v) in flat.items()}
        dcp.load(sd, storage_reader=reader, no_dist=not group)
        return _unflatten({k: (p, sd[k]) for k, (p, _) in flat.items()})

    def has_dcp_state(self) -> bool:
        fs_, d = self._resolved()
        return fsutil.isdir(fs_, fsutil.join(d, self._DCP_DIR))

    def metadata(self) -> dict:
        fs_, d = self._resolved()
        p = fsutil.join(d, _METADATA_FILE)
        if fsutil.isfile(fs_, p):
            return json.loads(fsutil.read_bytes(fs_, p))
        return {}

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (_rebuild_checkpoint, (self.path, self._filesystem))


def _rebuild_checkpoint(path, filesystem):
    return Checkpoint(path, filesystem=filesystem)


# -- state trees -----------------------------------------------------------

def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _to_host(x):
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        if not (x.flags.c_contiguous and x.flags.writeable):
            x = np.array(x, order="C")    # a copy torch may wrap
        return torch.from_numpy(x)
    if isinstance(x, np.generic) and x.dtype.kind in "biuf":
        # numpy scalars (np.int32(step)) as 0-d tensors: torch.load's
        # weights_only unpickler refuses numpy's scalar type
        return torch.from_numpy(np.asarray(x))
    return x


def _restore_into(target, loaded, where: tuple):
    """``loaded`` in ``target``'s structure, tensor dtypes and devices
    (flax ``from_bytes(target, ...)``'s role): dict keys must match."""
    import numpy as np
    import torch
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(target) != set(loaded):
            got = (sorted(map(str, loaded)) if isinstance(loaded, dict)
                   else type(loaded).__name__)
            raise ValueError(
                f"checkpoint state at {list(where)} has keys {got}, the "
                f"target {sorted(map(str, target))}")
        return {k: _restore_into(v, loaded[k], where + (k,))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(target) != len(loaded):
            raise ValueError(f"checkpoint state at {list(where)} has "
                             f"{len(loaded)} entries, the target "
                             f"{len(target)}")
        return type(target)(_restore_into(t, x, where + (i,))
                            for i, (t, x) in enumerate(zip(target, loaded)))
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(loaded).to(device=target.device,
                                          dtype=target.dtype, copy=True)
    if isinstance(target, np.ndarray):
        x = loaded.numpy() if isinstance(loaded, torch.Tensor) else loaded
        return np.asarray(x, dtype=target.dtype).copy()
    return loaded


def _fqn(path: tuple) -> str:
    return json.dumps(list(path))


def _flatten(tree, prefix: tuple = ()) -> dict:
    """{fqn: (key path, leaf)} through nested dicts (keys may be ints, as
    in an optimizer's ``state_dict()``)."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {_fqn(prefix): (prefix, tree)}


def _unflatten(flat: dict):
    root: dict = {}
    for path, leaf in flat.values():
        if not path:
            return leaf
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


class CheckpointManager:
    """Tracks reported checkpoints; prunes to num_to_keep keeping latest and
    best (reference: checkpoint_manager.py). `storage_dir` may be a local
    path or a storage URI — managed copies stream shard-by-shard through
    the filesystem (no whole-tree staging)."""

    def __init__(self, storage_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max", filesystem=None):
        self.dir = storage_dir
        self._filesystem = filesystem
        self._fs, self._fs_dir = fsutil.resolve(storage_dir, filesystem)
        fsutil.makedirs(self._fs, self._fs_dir)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self.history: list[tuple[Checkpoint, dict]] = []
        self._seq = 0  # monotonic: pruning must never reuse a dir name

    def register(self, ckpt: Checkpoint, metrics: dict) -> Checkpoint:
        """Persist a reported checkpoint into managed storage."""
        name = f"checkpoint_{self._seq:06d}"
        self._seq += 1
        dst_fs_path = fsutil.join(self._fs_dir, name)
        src_fs, src_path = ckpt._resolved()
        same = (type(src_fs) is type(self._fs)
                and src_path.rstrip("/") == dst_fs_path.rstrip("/"))
        if not same:
            fsutil.copy_tree(src_fs, src_path, self._fs, dst_fs_path)
        managed = Checkpoint(fsutil.join(self.dir, name),
                             filesystem=self._filesystem)
        self.history.append((managed, dict(metrics)))
        self._prune()
        return managed

    def scan_existing(self) -> int:
        """Rebuild ``history`` from ``checkpoint_*`` directories already
        present in managed storage — the kill-and-resume path: a
        restarted driver pointed at the same ``storage_dir`` picks up
        ``latest`` and continues instead of starting over. Metrics come
        back from each checkpoint's metadata (empty when absent); ``_seq``
        continues past the highest index so new registrations never
        reuse a directory name. Returns how many were found."""
        found: list[tuple[int, Checkpoint]] = []
        for p in fsutil.list_dirs(self._fs, self._fs_dir):
            name = p.rstrip("/").rsplit("/", 1)[-1]
            if not name.startswith("checkpoint_"):
                continue
            try:
                seq = int(name.split("_", 1)[1])
            except ValueError:
                continue
            found.append((seq, Checkpoint(fsutil.join(self.dir, name),
                                          filesystem=self._filesystem)))
        for seq, ckpt in sorted(found, key=lambda sc: sc[0]):
            try:
                meta = ckpt.metadata()
            except Exception:
                # a crash mid-write can truncate _metadata.json; the
                # checkpoint still lists (its restore path decides
                # whether the STATE loads)
                meta = {}
            self.history.append((ckpt, meta))
            self._seq = max(self._seq, seq + 1)
        return len(found)

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self.history[-1][0] if self.history else None

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self.history:
            return None
        if not self.score_attribute:
            return self.latest
        scored = [(c, m) for c, m in self.history
                  if self.score_attribute in m]
        if not scored:
            return self.latest
        key = lambda cm: cm[1][self.score_attribute]  # noqa: E731
        return (max if self.score_order == "max" else min)(scored, key=key)[0]

    def _prune(self):
        if self.num_to_keep is None:
            return
        keep = {id(self.latest), id(self.best)}
        kept, dropped = [], []
        for c, m in reversed(self.history):      # newest first
            if len(kept) < self.num_to_keep or id(c) in keep:
                kept.append((c, m))
            else:
                dropped.append(c)
        self.history = list(reversed(kept))
        for c in dropped:
            # best-effort: a transient storage error pruning an OLD
            # checkpoint must not fail the register() that just persisted
            # a new one
            try:
                fs_, p = c._resolved()
                fsutil.delete_dir(fs_, p)
            except Exception:
                pass  # retention delete races shared storage
