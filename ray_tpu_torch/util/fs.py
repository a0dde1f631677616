"""URI-aware storage: local paths through ``os``, URIs through pyarrow.

The port's copy of ``ray_tpu/util/fs.py`` (reference parity:
python/ray/data/datasource/path_util.py, where every file datasource
resolves user paths through ``pyarrow.fs``, and
python/ray/train/_checkpoint.py:56, where a Checkpoint is "a directory
on local or remote (e.g. cloud) storage"). Train checkpoints accept
``gs://`` / ``s3://`` / ``file://`` / plain local paths alike.

Where the reference resolves every path, a plain local one included,
to a ``pyarrow.fs.LocalFileSystem``, this module resolves plain local
paths and ``file://`` URIs to ``LOCAL`` and serves them with ``os`` and
``shutil``: the results (absolute paths, sorted listings, glob.glob
semantics) are the reference's, and a host without pyarrow reads,
writes, copies and lists checkpoints on its own disk. Other URIs and an
explicit ``filesystem=`` go through pyarrow, imported at that call.
Everything streams (open, read, write through the filesystem, chunked
copies), so shards never need a whole local copy.
"""
from __future__ import annotations

import fnmatch
import os
import posixpath
import shutil
from typing import Optional, Union
from urllib.parse import unquote, urlparse

_COPY_CHUNK = 8 << 20  # stream copies in 8 MiB chunks


class LocalFS:
    """The local disk, served through ``os``: what ``resolve`` returns for
    plain paths and ``file://`` URIs in the place of pyarrow's
    ``LocalFileSystem``."""


LOCAL = LocalFS()


def _parse_scheme(path: str) -> str:
    # windows drive letters ("C:\x") parse as a 1-char scheme; not a URI
    s = urlparse(path).scheme
    return s if len(s) > 1 else ""


def resolve(path: str, filesystem=None):
    """``(filesystem, fs_path)`` for a path that may be a URI.

    - explicit ``filesystem``: the URI scheme (if any) is stripped and the
      remainder handed to it verbatim (reference path_util behavior);
    - ``file://`` and plain paths: ``LOCAL``, the path made absolute;
    - ``gs://`` / ``s3://`` / ``hdfs://``: resolved via ``pyarrow.fs``.
      s3 is constructed directly with the env region
      (AWS_REGION/AWS_DEFAULT_REGION) because ``from_uri`` performs a
      network HeadBucket region lookup.
    """
    scheme = _parse_scheme(path)
    if filesystem is not None:
        if scheme:
            u = urlparse(path)
            path = (u.netloc + u.path) if u.netloc else u.path
        return filesystem, path
    if not scheme:
        return LOCAL, os.path.abspath(path)
    if scheme == "file":
        u = urlparse(path)
        return LOCAL, os.path.abspath(unquote(u.netloc + u.path))
    from pyarrow import fs as pafs
    if scheme == "s3":
        u = urlparse(path)
        region = os.environ.get("AWS_REGION") or os.environ.get(
            "AWS_DEFAULT_REGION") or "us-east-1"
        return pafs.S3FileSystem(region=region), u.netloc + u.path
    fs_, p = pafs.FileSystem.from_uri(path)
    return fs_, p


def is_local(fs_) -> bool:
    """``LOCAL``, or pyarrow's ``LocalFileSystem`` when pyarrow is loaded
    (an explicit one cannot exist otherwise)."""
    if isinstance(fs_, LocalFS):
        return True
    import sys
    pafs = sys.modules.get("pyarrow.fs")
    return pafs is not None and isinstance(fs_, pafs.LocalFileSystem)


def to_arrow(fs_):
    """A pyarrow filesystem for ``fs_``: ``LOCAL`` becomes pyarrow's
    ``LocalFileSystem`` (what the reference resolves local paths to), any
    other is returned as it is. For callers that hand the filesystem to
    pyarrow's readers and writers (the data library)."""
    if isinstance(fs_, LocalFS):
        from pyarrow import fs as pafs
        return pafs.LocalFileSystem()
    return fs_


def is_uri(path: str) -> bool:
    return bool(_parse_scheme(path))


def join(base: str, *parts: str) -> str:
    """Path join that keeps URIs URIs (posix separators)."""
    if is_uri(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


# -- single-file ops -------------------------------------------------------

def _type(fs_, path: str) -> str:
    """"file", "dir" or "" (not found)."""
    if isinstance(fs_, LocalFS):
        return ("dir" if os.path.isdir(path) else
                "file" if os.path.exists(path) else "")
    from pyarrow import fs as pafs
    t = fs_.get_file_info(path).type
    return ("dir" if t == pafs.FileType.Directory else
            "" if t == pafs.FileType.NotFound else "file")


def exists(fs_, path: str) -> bool:
    return _type(fs_, path) != ""


def isdir(fs_, path: str) -> bool:
    return _type(fs_, path) == "dir"


def isfile(fs_, path: str) -> bool:
    return _type(fs_, path) == "file"


def makedirs(fs_, path: str) -> None:
    if isinstance(fs_, LocalFS):
        os.makedirs(path, exist_ok=True)
    else:
        fs_.create_dir(path, recursive=True)


def _open_input(fs_, path: str):
    if isinstance(fs_, LocalFS):
        return open(path, "rb")
    return fs_.open_input_stream(path)


def _open_output(fs_, path: str):
    parent = posixpath.dirname(path.replace(os.sep, "/"))
    if parent:
        makedirs(fs_, parent)
    if isinstance(fs_, LocalFS):
        return open(path, "wb")
    return fs_.open_output_stream(path)


def read_bytes(fs_, path: str) -> bytes:
    with _open_input(fs_, path) as f:
        return f.read()


def write_bytes(fs_, path: str, data: bytes) -> None:
    with _open_output(fs_, path) as f:
        f.write(data)


def delete_dir(fs_, path: str) -> None:
    try:
        if isinstance(fs_, LocalFS):
            shutil.rmtree(path)
        else:
            fs_.delete_dir(path)
    except FileNotFoundError:
        pass


def _entries(fs_, path: str, recursive: bool) -> list[tuple[str, bool]]:
    """``(path, is_dir)`` under a directory; none when it does not exist
    (pyarrow's ``FileSelector(allow_not_found=True)``). Raises
    NotADirectoryError when ``path`` is a file."""
    if not isinstance(fs_, LocalFS):
        from pyarrow import fs as pafs
        sel = pafs.FileSelector(path, recursive=recursive,
                                allow_not_found=True)
        return [(i.path, i.type == pafs.FileType.Directory)
                for i in fs_.get_file_info(sel)
                if i.type != pafs.FileType.NotFound]
    if not recursive:
        try:
            with os.scandir(path) as it:
                return [(posixpath.join(path, e.name), e.is_dir())
                        for e in it]
        except FileNotFoundError:
            return []
    out: list[tuple[str, bool]] = []
    if os.path.isfile(path):
        raise NotADirectoryError(path)
    for root, dirs, files in os.walk(path):
        out += [(posixpath.join(root, d), True) for d in dirs]
        out += [(posixpath.join(root, f), False) for f in files]
    return out


def list_files(fs_, path: str) -> list[str]:
    """Recursive file listing under a directory (sorted)."""
    return sorted(p for p, is_dir in _entries(fs_, path, True)
                  if not is_dir)


def list_dirs(fs_, path: str) -> list[str]:
    """Immediate subdirectories of a directory (sorted full paths)."""
    return sorted(p for p, is_dir in _entries(fs_, path, False) if is_dir)


def _is_glob(s: str) -> bool:
    return any(c in s for c in "*?[")


def glob_files(fs_, pattern: str) -> list[str]:
    """Glob with glob.glob semantics: ``*`` and ``?`` do NOT cross ``/``
    (only ``**`` recurses). Expands segment-by-segment with one directory
    listing per glob level, so a shallow pattern on an object store never
    enumerates the whole bucket."""
    pat = pattern.replace(os.sep, "/")
    parts = pat.split("/")
    i = next(j for j, s in enumerate(parts) if _is_glob(s))
    base = "/".join(parts[:i])
    rest = parts[i:]
    if "**" in rest:
        # recursive pattern: full listing from the prefix + whole-path
        # match. glob.glob's "**/" means ZERO or more directories, so
        # match against every variant with "**/" elided too.
        variants = {pat}
        frontier = [pat]
        while frontier:
            p = frontier.pop()
            if "**/" in p:
                q = p.replace("**/", "", 1)
                if q not in variants:
                    variants.add(q)
                    frontier.append(q)
        return sorted(
            q for q in list_files(fs_, base)
            if any(fnmatch.fnmatch(q.replace(os.sep, "/"), v)
                   for v in variants))
    cands = [base]
    for k, seg in enumerate(rest):
        last = k == len(rest) - 1
        nxt: list[str] = []
        for b in cands:
            if not _is_glob(seg):
                nxt.append(f"{b}/{seg}" if b else seg)
                continue
            try:
                entries = _entries(fs_, b, False)
            except (OSError, NotADirectoryError):
                continue  # a literal segment landed on a file
            for p, is_dir in entries:
                # only the final segment may match files
                if not last and not is_dir:
                    continue
                name = p.rstrip("/").rsplit("/", 1)[-1]
                if fnmatch.fnmatch(name, seg):
                    nxt.append(p)
        cands = nxt
    if not cands:
        return []
    if isinstance(fs_, LocalFS):
        return sorted(c for c in cands if os.path.isfile(c))
    from pyarrow import fs as pafs
    return sorted(i_.path for i_ in fs_.get_file_info(cands)
                  if i_.type == pafs.FileType.File)


def expand_paths(paths: Union[str, list],
                 filesystem=None) -> tuple[object, list[str]]:
    """Resolve user paths (str or list; URIs, dirs, globs) to
    ``(filesystem, [file paths])``. All paths must land on one filesystem
    (reference path_util raises on mixed schemes too)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [os.fspath(paths)]
    fs_ = filesystem
    out: list[str] = []
    for p in paths:
        f, fp = resolve(os.fspath(p), fs_)
        if fs_ is None:
            fs_ = f
        elif type(f) is not type(fs_):
            raise ValueError(
                f"all paths must share one filesystem; {p!r} resolved to "
                f"{type(f).__name__} but earlier paths to "
                f"{type(fs_).__name__}")
        if _is_glob(fp):
            out.extend(glob_files(fs_, fp))
        elif isdir(fs_, fp):
            out.extend(list_files(fs_, fp))
        else:
            out.append(fp)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return fs_, out


# -- tree copies (stream, never materialize a tree in memory) --------------

def copy_file(src_fs, src: str, dst_fs, dst: str) -> None:
    if isinstance(src_fs, LocalFS) and isinstance(dst_fs, LocalFS):
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.copyfile(src, dst)  # in the kernel (copy_file_range)
        return
    with _open_input(src_fs, src) as fin, \
            _open_output(dst_fs, dst) as fout:
        while True:
            chunk = fin.read(_COPY_CHUNK)
            if not chunk:
                break
            fout.write(chunk)


def copy_tree(src_fs, src: str, dst_fs, dst: str) -> None:
    """Recursive dir copy across (possibly different) filesystems,
    streaming each file in chunks."""
    makedirs(dst_fs, dst)
    src_norm = src.rstrip("/")
    for f in list_files(src_fs, src_norm):
        rel = f[len(src_norm):].lstrip("/")
        copy_file(src_fs, f, dst_fs, posixpath.join(dst, rel))


def download_dir(fs_, path: str, local_dir: Optional[str] = None) -> str:
    """Materialize a (remote) directory locally; identity for local
    paths."""
    if is_local(fs_):
        return path
    import tempfile
    d = local_dir or tempfile.mkdtemp(prefix="rtpu_fsdl_")
    copy_tree(fs_, path, LOCAL, os.path.abspath(d))
    return d
