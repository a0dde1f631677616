"""The kernel build's bookkeeping, which runs without nvcc: the ptxas -v
report parsed per kernel, and the build log kept beside a library so a
cached build still reports its registers and spills."""
import os

from ray_tpu_torch.ops import _build

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
