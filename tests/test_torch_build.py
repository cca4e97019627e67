"""The kernels' build cache (``repro_torch.kernels.build``) on the CPU: a
library's file name carries a digest of its ``.cu`` source, of every
``.cuh`` header beside it and of the compiler flags, so an edited header is
rebuilt instead of a stale library being loaded. Also the reader of the
build's ``ptxas`` report. Needs no ``nvcc``: only the paths are computed."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint k;\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nint helper;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_is_stable_when_nothing_changes(csrc):
    first = build.library_path("k")
    assert build.library_path("k") == first
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("libk_") and first.suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "new_header", "source", "flags"])
def test_library_path_changes_with_any_source_or_header(csrc, edit,
                                                        monkeypatch):
    before = build.library_path("k")
    if edit == "flags":
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    elif edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\nint helper2;\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    else:
        (csrc / "k.cu").write_text('#include "common.cuh"\nint k2;\n')
    assert build.library_path("k") != before


def test_library_path_ignores_other_kernels_sources(csrc):
    before = build.library_path("k")
    (csrc / "other.cu").write_text("int other;\n")
    assert build.library_path("k") == before


def test_flash_source_includes_the_shared_hopper_header():
    """The header whose edits the digest must follow is the one the
    tensor-core flash kernel includes."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert '#include "hopper.cuh"' in src
    assert (build.CSRC / "hopper.cuh").exists()
    assert "wgmma" in src and "mma.sync" not in src


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea728flash_attention_wgmma_kernelILi256EEEv14CUtensorMap_stS1_S1_NS_5WArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea728flash_attention_wgmma_kernelILi256EEEv14CUtensorMap_stS1_S1_NS_5WArgsE
    264 bytes stack frame, 392 bytes spill stores, 360 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 264 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea722flash_attention_kernelI13__nv_bfloat16Li32ELi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea722flash_attention_kernelI13__nv_bfloat16Li32ELi64EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 71 registers, used 1 barriers
ptxas info    : Function properties for _Z17loo_trials_kernelPKfS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
"""


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    rep = build.ptxas_report(PTXAS_LOG)
    assert rep == {
        "flash_attention_wgmma_kernel<256>": {
            "spill_stores": 392, "spill_loads": 360, "registers": 168},
        "flash_attention_kernel<bf16,32,64>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 71},
        "loo_trials_kernel": {
            "spill_stores": 0, "spill_loads": 0, "registers": 40}}


def test_kernel_label_reads_bool_template_arguments():
    """The loo_trials kernel is instantiated per D bucket and per entry
    (plain or fused): each instantiation keeps its own ptxas row."""
    symbol = ("_ZN46_GLOBAL__N__0badc0de_13_loo_trials_cu_12345678"
              "17loo_trials_kernelILi32ELb1EEEvNS_4ArgsE")
    assert build.kernel_label(symbol) == "loo_trials_kernel<32,1>"
    log = PTXAS_LOG + "\n".join(
        f"ptxas info    : Function properties for {symbol.replace(a, b)}\n"
        f"    0 bytes stack frame, {s} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {r} registers"
        for a, b, s, r in (("Li32ELb1", "Li32ELb1", 0, 128),
                           ("Li32ELb1", "Li16ELb0", 8, 127)))
    rep = build.ptxas_report(log)
    assert rep["loo_trials_kernel<32,1>"]["registers"] == 128
    assert rep["loo_trials_kernel<16,0>"]["spill_stores"] == 8


BUILD_IN_CHILD = """
import sys
from pathlib import Path
from repro_torch.kernels import build
root = Path(sys.argv[1])
build.CSRC, build.BUILD_DIR = root / "csrc", root / "build"
build.nvcc_path = lambda: str(root / "nvcc")
print(build.build(["k"])["k"])
"""

FAKE_NVCC = """#!/bin/sh
# counts its runs, takes a while, writes its -o output and a report
echo run >> "$(dirname "$0")/nvcc_runs"
sleep 1
while [ "$1" != "-o" ]; do shift; done
echo lib > "$2"
echo "ptxas info    : Used 8 registers"
"""


def test_processes_building_at_once_compile_once(tmp_path):
    """Two processes that call ``build`` on the same source at once: one
    runs ``nvcc`` while the other waits on the build directory's lock,
    then finds the library built; both return it, with its report."""
    import os
    import subprocess
    import sys

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("int k;\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    src = os.path.dirname(os.path.dirname(os.path.dirname(build.__file__)))
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_IN_CHILD,
                               str(tmp_path)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    libs = {out.strip() for out, _ in outs}
    assert len(libs) == 1
    lib = libs.pop()
    assert open(lib).read() == "lib\n"
    assert (tmp_path / "nvcc_runs").read_text() == "run\n"
    log = open(lib[:-3] + ".log").read()
    assert build.ptxas_report(log) == {}
    assert "Used 8 registers" in log
    assert not list((tmp_path / "build").glob("*.tmp"))
