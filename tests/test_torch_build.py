"""The build cache of the port's kernel libraries: a library is named by a
hash of its source, the compiler command and every header the source
includes from ``csrc/``, so that an edited header never leaves a stale
library to be loaded.  Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from treedetection_tpu_torch import build, native  # noqa: F401
from treedetection_tpu_torch.ops.kernels import (  # noqa: F401
    pairwise, relpos_attention, roi_align)

CSRC = build.CSRC
# library -> the headers its source must hash (K1, K5 and K6 share
# pool_box_bf16 and pool_box)
LIBRARIES = {
    "roi_pool_flat": {"roi_pool_bf16.cuh", "roi_pool_window.cuh"},
    "roi_pool_levels": {"roi_pool_bf16.cuh", "roi_pool_window.cuh"},
    "roi_pool_resident": {"roi_pool_bf16.cuh", "roi_pool_window.cuh"},
    "roi_pool_prep": set(),
    "pairwise_boxes": set(),
    "relpos_attention": set(),
}


def test_libraries_cover_every_kernel_source():
    assert {p.stem for p in CSRC.glob("*.cu")} == set(LIBRARIES)
    cuda = {name: lib for name, lib in build.LIBRARIES.items()
            if lib.compiler == "nvcc"}
    assert set(cuda) == set(LIBRARIES)
    assert all(lib.sources == (CSRC / f"{name}.cu",)
               for name, lib in cuda.items())


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_an_edited_header_renames_exactly_its_libraries(tmp_path, name):
    """Each kernel library hashes the headers its source includes, and no
    other: appending a comment to one of them names another library; to a
    header it does not include, the same one."""
    shutil.copytree(CSRC, tmp_path / "csrc")
    src = tmp_path / "csrc" / f"{name}.cu"
    command = ["nvcc", *build.LIBRARIES[name].flags]
    assert {p.name for p in build.local_headers([src])} == LIBRARIES[name]
    before = build.library_path(name, [src], command)
    assert before.parent == build.BUILD_DIR
    for header in sorted((tmp_path / "csrc").glob("*.cuh")):
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        renamed = build.library_path(name, [src], command) != before
        assert renamed == (header.name in LIBRARIES[name]), header.name
        header.write_text(text)
    assert build.library_path(name, [src], command) == before
