"""The kernels' host-side bookkeeping, which runs without nvcc: the ptxas
-v report parsed per kernel, the build log kept beside a library so a
cached build still reports its registers and spills, the build key that
follows the headers a source includes, the paged kernels' split counts,
and the kernel names chip_smoke.py expects, read from the sources."""
import importlib
import importlib.util
import os
import re

import pytest
import torch

from ray_tpu_torch.ops import _build

rpa = importlib.import_module("ray_tpu_torch.ops.ragged_paged_attention")
pda = importlib.import_module("ray_tpu_torch.ops.paged_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4anon19flash_dq_kernel_mmaILi128EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN4anon19flash_dq_kernel_mmaILi128EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4anon16flash_fwd_kernelIfLi128EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN4anon16flash_fwd_kernelIfLi128EEEvPKT_
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 1024 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_is_parsed_per_kernel():
    got = _build.ptxas_kernels(LOG)
    assert got == {
        "_ZN4anon19flash_dq_kernel_mmaILi128EEEvPK13__nv_bfloat16": dict(
            stack=0, spill_stores=0, spill_loads=0, registers=232,
            static_smem=0),
        "_ZN4anon16flash_fwd_kernelIfLi128EEEvPKT_": dict(
            stack=16, spill_stores=16, spill_loads=16, registers=128,
            static_smem=1024),
    }
    assert _build.ptxas_kernels("nvcc: no entry functions\n") == {}


def test_cached_build_returns_the_log_kept_beside_its_library(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    lib = _build._lib_path("flash_attention")
    os.makedirs(os.path.dirname(lib))
    open(lib, "wb").close()
    # built, no log kept: an empty report, not an error
    assert _build._finish("flash_attention", _build._start("flash_attention"),
                          0.0) == {"seconds": 0.0, "log": ""}
    with open(lib + ".log", "w") as f:
        f.write(LOG)
    rec = _build._finish("flash_attention", _build._start("flash_attention"),
                         0.0)
    assert rec == {"seconds": 0.0, "log": LOG}


def test_lib_path_follows_the_headers_a_source_includes(tmp_path,
                                                        monkeypatch):
    """Editing a csrc header that a source includes (directly or through
    another header) moves that library's build path; editing a header it
    does not include, or a system header name, does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "x.cuh"  // helpers\nint a;\n')
    (csrc / "x.cuh").write_text('#pragma once\n  # include "y.cuh"\n')
    (csrc / "y.cuh").write_text("// y\n")
    (csrc / "z.cuh").write_text("// not included\n")
    (csrc / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    assert _build._sources_of("a") == ["a.cu", "x.cuh", "y.cuh"]
    assert _build._sources_of("b") == ["b.cu"]
    a0, b0 = _build._lib_path("a"), _build._lib_path("b")
    (csrc / "z.cuh").write_text("// edited, still not included\n")
    assert (_build._lib_path("a"), _build._lib_path("b")) == (a0, b0)
    (csrc / "y.cuh").write_text("// y, edited\n")
    a1 = _build._lib_path("a")
    assert a1 != a0 and _build._lib_path("b") == b0
    (csrc / "x.cuh").write_text('#pragma once\n#include "y.cuh"\n// x\n')
    assert _build._lib_path("a") not in (a0, a1)


def test_both_attention_sources_key_on_the_shared_header():
    assert _build._sources_of("flash_attention") == ["flash_attention.cu",
                                                     "mma_sm90.cuh"]
    assert _build._sources_of("ragged_paged_attention") == [
        "ragged_paged_attention.cu", "mma_sm90.cuh"]
    assert _build._sources_of("paged_attention") == ["paged_attention.cu",
                                                     "mma_sm90.cuh"]


@pytest.mark.parametrize("n_flat,rows", [(1, 16), (4, 16), (16, 16),
                                         (17, 32), (20, 32), (32, 32),
                                         (33, 64), (512, 64)])
def test_ragged_rows_per_block(n_flat, rows):
    """1, 2 or 4 warps of 16 flat rows a block."""
    assert rpa.rows_per_block(n_flat) == rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q,max_pages,page,want", [
    (128, 64, 16, 1),    # 8B prefill chunk rows: unsplit
    (33, 64, 16, 1),     # just past the widest split window
    (1, 64, 16, 8),      # 8B decode: 8 pages (128 keys) a split
    (5, 64, 16, 8),      # 8B verify
    (1, 512, 16, 64),    # long rows
    (32, 4, 16, 1),      # a table narrower than one split
    (1, 127, 8, 8),      # page 8: 16 pages a split
    (1, 3, 256, 3),      # pages wider than SPLIT_KEYS: one page a split
])
def test_ragged_split_count(dtype, q, max_pages, page, want):
    """Prefill widths run unsplit; decode and verify widths cut every row
    into runs of split_pages(page) whole pages, enough to cover the
    table, in either dtype (f32 splits too). The pages of split s depend
    only on s and the page size: the same in a wider table (more splits,
    left empty by short rows), with any row count and any other rows."""
    n = rpa.num_splits(q, max_pages, page)
    assert n == want
    assert rpa.launch_plan(dtype, q, 4, max_pages, page)[0] == want
    sp = rpa.split_pages(page)
    assert sp == max(1, rpa.SPLIT_KEYS // page)
    assert n == 1 or n * sp >= max_pages > (n - 1) * sp
    if n > 1:
        # a table twice as wide keeps every split's pages and adds splits
        assert rpa.num_splits(q, 2 * max_pages, page) >= n
        assert rpa.split_pages(page) == sp


@pytest.mark.parametrize("dtype,q,groups,warps", [
    (torch.bfloat16, 1, 4, 1), (torch.bfloat16, 5, 4, 2),
    (torch.bfloat16, 128, 4, 4), (torch.float32, 1, 4, 1),
    (torch.float32, 5, 4, 1), (torch.float32, 128, 4, 1)])
def test_ragged_launch_plan_warps(dtype, q, groups, warps):
    """bf16 pass-1 blocks follow the flat rows (1, 2 or 4 warps); the f32
    kernel has one layout."""
    assert rpa.launch_plan(dtype, q, groups, 64, 16)[1] == warps


@pytest.mark.parametrize("max_pages,page,want", [
    (64, 16, 8),         # 8B decode table: 8 pages (128 keys) a split
    (520, 16, 65),       # the 8,192-token row's table
    (4, 16, 1),          # narrower than one split
    (8, 16, 1),          # exactly one split
    (9, 16, 2),          # one page past it
    (127, 8, 8),         # page 8: 16 pages a split
    (3, 256, 3),         # pages wider than SPLIT_KEYS: one page a split
    (1, 16, 1),
])
def test_paged_decode_split_count(max_pages, page, want):
    """B2 cuts a row's keys into runs of split_pages(page) whole pages,
    B1's rule: the count follows the table width and the page size alone
    (the signature takes nothing else: no batch, no lengths, no SM
    count), covers the table, and a wider table keeps every split's
    pages and only adds splits."""
    n = pda.decode_splits(max_pages, page)
    assert n == want
    sp = pda.split_pages(page)
    assert sp == rpa.split_pages(page) == max(1, pda.SPLIT_KEYS // page)
    assert n * sp >= max_pages > (n - 1) * sp
    for wider in (max_pages + 1, 2 * max_pages, 8 * max_pages):
        assert pda.decode_splits(wider, page) >= n
    assert rpa.num_splits(1, max_pages, page) == n


@pytest.mark.parametrize("batch,heads,kv_heads,want", [
    (9, 32, 8, 72),      # 8B decode: G 4, one row tile per kv head
    (1, 32, 8, 8),
    (4, 40, 2, 40),      # G 20: five row tiles per kv head
    (3, 8, 8, 24),       # G 1: one tile, three warps idle
    (2, 12, 2, 8),       # G 6: a full tile and a half one
    (0, 32, 8, 0),
])
def test_paged_decode_merge_counters(batch, heads, kv_heads, want):
    """Each B2 call takes its own arrival counters: one per (row, kv
    head, tile of up to four query heads), the kernel's grid less its
    split axis, whatever the table width."""
    assert pda.merge_counters(batch, heads, kv_heads) == want
    tiles = -(-(heads // kv_heads) // pda._KERNEL_ROWS)
    assert want == batch * kv_heads * tiles


def _source(lib: str) -> str:
    with open(os.path.join(_build.CSRC, _build.SOURCES[lib])) as f:
        return f.read()


def _kernels_defined(lib: str) -> set:
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                          r"\s*)?(\w+)\s*\(", _source(lib)))


@pytest.mark.parametrize("label", chip_smoke.PHASE2_KERNELS)
def test_chip_smoke_expects_only_kernels_the_sources_define(label):
    """Each build phase 2 requires is a kernel of one of the libraries it
    reads, and the name of its instantiation, mangled as nvcc mangles it
    in the anonymous namespace, parses back to the label: a stale name
    fails here and not as a KeyError on the card."""
    name, dtype, d, *nw = label.split()
    defined = set().union(*(_kernels_defined(lib)
                            for lib in chip_smoke._KERNEL_LIBS))
    assert name in defined
    typed = not name.endswith(("_mma", "_f32"))
    args = (("f" if dtype == "float32" else "13__nv_bfloat16") if typed
            else "") + f"Li{d[1:]}E" + (f"Li{nw[0][2:]}E" if nw else "")
    mangled = f"_ZN12_GLOBAL__N_1{len(name)}{name}I{args}EEvPKf"
    assert chip_smoke._kernel_symbol(mangled) == (
        name, dtype, int(d[1:]), int(nw[0][2:]) if nw else None)


def test_chip_smoke_f32_kernel_names_are_phase_2_builds():
    """Phase 3b's F32_KERNEL and phase 2's cp.async list name kernels
    that phase 2 requires at both head dims."""
    built = set(chip_smoke.PHASE2_KERNELS)
    for name in chip_smoke.F32_KERNEL.values():
        assert {f"{name} float32 D{d}" for d in (64, 128)} <= built
    names = {label.split()[0] for label in built}
    assert set(chip_smoke.F32_CP_ASYNC) <= names


@pytest.mark.parametrize("gone", [
    "flash_fwd_kernel<", "flash_dq_kernel<", "FwdCfg", "DqCfg",
    "stage_rows", "dot_tile", "pv_tile", "struct Elem", "group_max",
    "group_sum"])
def test_first_f32_forward_and_dq_kernels_are_gone(gone):
    """The f32 forward and dq run the CUDA-core kernels built on the dkv
    kernel's pieces; the first design's templates and the helpers only
    they used are no longer in the source."""
    assert gone not in _source("flash_attention")
    assert {"flash_fwd_kernel_f32", "flash_dq_kernel_f32"} <= \
        _kernels_defined("flash_attention")
