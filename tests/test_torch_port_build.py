"""The port's CUDA build: each library is keyed on its source, every shared
header (`csrc/*.cuh`) and the compiler flags, so an edited header rebuilds
every kernel and an edited source only its own. CPU only: nothing here runs
nvcc."""

import importlib

import pytest

build = importlib.import_module("geoestimation_tpu_torch.ops._build")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "core.cuh"\n// a\n')
    (tmp_path / "b.cu").write_text('#include "core.cuh"\n// b\n')
    (tmp_path / "core.cuh").write_text("// core v1\n")
    return tmp_path


def paths():
    return {name: build.library_path(name) for name in build.sources()}


def test_sources_are_the_cu_files(csrc):
    assert build.sources() == ["a", "b"]


def test_library_path_names_its_source(csrc):
    for name, path in paths().items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


def test_path_is_stable_for_unchanged_files(csrc):
    assert paths() == paths()


def test_editing_a_header_changes_every_library(csrc):
    before = paths()
    (csrc / "core.cuh").write_text("// core v2\n")
    after = paths()
    assert all(before[name] != after[name] for name in before)


@pytest.mark.parametrize("change", ["add", "rename", "remove"])
def test_the_set_of_headers_is_in_the_key(csrc, change):
    before = paths()
    header = csrc / "core.cuh"
    if change == "add":
        (csrc / "extra.cuh").write_text("// extra\n")
    elif change == "rename":
        header.rename(csrc / "core2.cuh")
    else:
        header.unlink()
    after = paths()
    assert all(before[name] != after[name] for name in before)


def test_editing_one_source_changes_only_its_library(csrc):
    before = paths()
    (csrc / "a.cu").write_text('#include "core.cuh"\n// a v2\n')
    after = paths()
    assert before["a"] != after["a"]
    assert before["b"] == after["b"]


def test_flags_are_in_the_key(csrc, monkeypatch):
    before = paths()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = paths()
    assert all(before[name] != after[name] for name in before)


def test_the_kernels_share_one_core_and_call_no_library():
    """Both fused-bottleneck sources include the shared sm_90a core and keep
    no copy of its helpers; the int8 convolution keeps its own: s8 wgmma on
    shared-memory tiles that TMA brings in, completed on mbarriers, with its
    epilogue's fmas written out; the train-mode BatchNorm's needs neither
    and adds its blocks' sums with integer tickets, no float atomics; the
    convolution epilogue needs none of these and rounds each float32 sum
    to bf16 on its own; none reaches a library kernel."""
    fused = ["fused_bottleneck", "fused_bottleneck_s2"]
    assert build.sources() == ["bn_train", "conv_epilogue", "conv_s8"] + fused
    epi = (build.CSRC_DIR / "conv_epilogue.cu").read_text()
    for absent in ("bottleneck_sm90.cuh", "wgmma", "atomic", "__shared__"):
        assert absent not in epi, absent
    assert "__float2bfloat16_rn(__fadd_rn(" in epi
    bn = (build.CSRC_DIR / "bn_train.cu").read_text()
    assert "bottleneck_sm90.cuh" not in bn and "wgmma" not in bn
    tickets = [line.split("atomicAdd(")[1].split(",")[0]
               for line in bn.splitlines() if "atomicAdd(" in line]
    assert tickets == ["counter + blockIdx.x"]
    core = (build.CSRC_DIR / "bottleneck_sm90.cuh").read_text()
    assert "wgmma.mma_async" in core and "cp.async.bulk.tensor" in core
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    for name in fused:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "bottleneck_sm90.cuh"' in text
        for copied in ("wgmma.mma_async", "mbarrier.init", "mma.sync"):
            assert copied not in text, (name, copied)
    conv = (build.CSRC_DIR / "conv_s8.cu").read_text()
    for wgmma in ("m64n64k32.s32.s8.s8", "m64n128k32.s32.s8.s8"):
        assert f"wgmma.mma_async.sync.aligned.{wgmma}" in conv
    assert "cp.async.bulk.tensor" in conv and "mbarrier.try_wait" in conv
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in conv
    assert "mma.sync" not in conv and "bottleneck_sm90.cuh" not in conv
    assert "__fmaf_rn" in conv and "__fmul_rn" in conv and "__fadd_rn" in conv
    for name in build.sources():
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        for library in ("cublas", "cudnn", "cutlass", "cute/"):
            assert library not in text.lower(), (name, library)
