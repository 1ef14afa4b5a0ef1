"""Each native library's declaration against its C source and its compile
command.  Every ``int td_*(...)`` inside an ``extern "C"`` block of
``csrc/*.cu`` is bound by the library built from that file, with one ctypes
type per C parameter; a launch entry takes the stream last, where
``build.launch`` appends it.  Each library's compile command is the one its
``_build/<name>-<hash>.so`` name was hashed from, so an unchanged source is
never rebuilt.  Runs on the CPU: nothing is compiled."""

import ctypes
import re
from pathlib import Path

import pytest

from treedetection_tpu_torch import build, native
from treedetection_tpu_torch.ops.kernels import (  # noqa: F401
    pairwise, relpos_attention, roi_align)

_EXTERN_C = re.compile(r'extern "C" \{(.*?)\}  // extern "C"', re.S)
_ENTRY = re.compile(r"^int (td_\w+)\(([^)]*)\)", re.M)
# C parameter type (its name dropped) -> the ctypes type that binds it
_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float,
          "long long": ctypes.c_longlong}


def _c_entries():
    """entry -> (library, [C parameters]) of every csrc/*.cu file."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for block in _EXTERN_C.findall(src.read_text()):
            for entry, params in _ENTRY.findall(block):
                found[entry] = (src.stem, [" ".join(p.split())
                                           for p in params.split(",")])
    return found


C_ENTRIES = _c_entries()


def _ctype(param: str):
    kind = param.rsplit(" ", 1)[0]
    return ctypes.c_void_p if "*" in param else _CTYPE[kind]


def test_every_bound_cuda_entry_is_in_its_source():
    bound = {entry: name for name, lib in build.LIBRARIES.items()
             if lib.compiler == "nvcc" for entry in lib.entries}
    assert bound == {entry: lib for entry, (lib, _) in C_ENTRIES.items()}
    assert len(bound) == 11


@pytest.mark.parametrize("entry", sorted(C_ENTRIES))
def test_binding_matches_the_c_signature(entry):
    name, params = C_ENTRIES[entry]
    argtypes = build.LIBRARIES[name].entries[entry]
    assert argtypes == [_ctype(p) for p in params], params
    streams = [i for i, p in enumerate(params) if p.endswith(" stream")]
    if entry != "td_roi_pool_bf16_smem_bytes":   # the one query entry
        assert streams == [len(params) - 1] and params[-1] == "void* stream"
    else:
        assert streams == []


NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# library -> its compile command ("nvcc": the compiler nvcc_path finds)
COMMANDS = {
    "roi_pool_flat": ["nvcc"] + NVCC,
    "roi_pool_levels": ["nvcc"] + NVCC,
    "roi_pool_resident": ["nvcc"] + NVCC,
    "roi_pool_prep": ["nvcc"] + NVCC,
    "relpos_attention": ["nvcc"] + NVCC,
    "pairwise_boxes": ["nvcc"] + NVCC[:4] + ["-fmad=false"] + NVCC[4:],
    "td_native": ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"],
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_compile_command_and_library_name_are_kept(monkeypatch, name):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    lib = build.LIBRARIES[name]
    assert lib.command() == COMMANDS[name]
    source = (Path(native.__file__).parent / "contour.cpp"
              if name == "td_native" else build.CSRC / f"{name}.cu")
    assert lib.sources == (source,)
