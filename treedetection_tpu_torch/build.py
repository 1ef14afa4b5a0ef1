"""Build the port's native libraries from the sources in this package.

Every shared library (the host C++ helpers under ``native/`` and the CUDA
kernels under ``csrc/``) is compiled at first use into ``_build/`` beside this
file, named by a hash of its sources, the headers they include from their own
directory and the compiler command, so an edited source or header always
rebuilds and a stale binary is never loaded.  The compile writes to a
temporary name and renames it into place, which keeps concurrent builders
(test workers, threads) from loading a half-written file.  A failed build
raises: there is no fallback library.

It is also the one place where a library is loaded, bound, launched and
counted.  A :class:`Library`, declared once beside the wrapper that calls it,
names its sources, its compile command and the C signature of each entry;
:func:`load` builds and binds it at first use; :func:`launch` calls a CUDA
entry on a device's current stream, raises on the CUDA error it returns and
counts the launch; :func:`launch_counts` reads and resets every counter.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Counter, Dict, List, Sequence, Tuple

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CSRC = Path(__file__).resolve().parent / "csrc"

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(sources: Sequence[Path]) -> List[Path]:
    """The headers that ``sources`` include with ``#include "..."`` from
    their own directory, and those that these include in turn, sorted."""
    found, todo = set(), [Path(s) for s in sources]
    while todo:
        src = todo.pop()
        for name in _LOCAL_INCLUDE.findall(src.read_text()):
            header = src.parent / name
            if header.is_file() and header not in found:
                found.add(header)
                todo.append(header)
    return sorted(found)


def library_path(name: str, sources: Sequence[Path],
                 command: List[str]) -> Path:
    """``_build/<name>-<hash>.so``: the hash covers ``command``, the sources
    and :func:`local_headers`, so an edited header names another library."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in list(sources) + local_headers(sources):
        digest.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_shared_library(name: str, sources: Sequence[Path],
                         command: List[str]) -> Path:
    """Compile ``sources`` with ``command`` (the compiler and its flags,
    without sources or ``-o``) into :func:`library_path` unless that file
    already exists; returns its path.  The compiler's output is kept beside
    the library as ``<name>-<hash>.log``."""
    out = library_path(name, sources, command)
    with _lock(name):
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                command + [str(s) for s in sources] + ["-o", tmp],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({proc.returncode}):\n"
                    f"{' '.join(command)}\n{proc.stderr[-4000:]}")
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def nvcc_flags(*extra: str) -> Tuple[str, ...]:
    """nvcc's flags for a kernel library: ``sm_90a``, C++17 and ``-O3``,
    then ``extra``, then a shared library with ptxas's register and
    shared-memory report (``-Xptxas -v``, kept in the build log)."""
    return ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            *extra, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


NVCC_FLAGS = nvcc_flags()
# every declared library by name
LIBRARIES: Dict[str, "Library"] = {}


@dataclass(eq=False)
class Library:
    """A native library: ``sources`` compiled with ``compiler`` and
    ``flags`` (``"nvcc"`` is found by :func:`nvcc_path`), and its C entries,
    each ``int entry(...)`` bound with the ctypes ``argtypes`` given."""
    name: str
    sources: Tuple[Path, ...]
    entries: Dict[str, list]
    flags: Tuple[str, ...] = NVCC_FLAGS
    compiler: str = "nvcc"

    def __post_init__(self):
        LIBRARIES[self.name] = self

    def command(self) -> List[str]:
        """The compiler and its flags, without sources or ``-o``."""
        compiler = nvcc_path() if self.compiler == "nvcc" else self.compiler
        return [compiler, *self.flags]

    def build(self) -> Path:
        """Compile (or find) the library; returns its path."""
        return build_shared_library(self.name, self.sources, self.command())


def cuda_library(name: str, entries: Dict[str, list],
                 *extra_flags: str) -> Library:
    """The kernel library ``csrc/<name>.cu``, built with
    :func:`nvcc_flags` of ``extra_flags``."""
    return Library(name, (CSRC / f"{name}.cu",), entries,
                   nvcc_flags(*extra_flags))


_loaded: Dict[str, ctypes.CDLL] = {}
_launches: Counter[str] = collections.Counter()
# binds a loaded library, counts a launch
_load_count_lock = threading.Lock()


def load(library: Library) -> ctypes.CDLL:
    """``library`` built, loaded and bound at first use (its build under
    its own lock, so a compile holds up no other library)."""
    lib = _loaded.get(library.name)
    if lib is None:
        path = library.build()
        with _load_count_lock:
            lib = _loaded.get(library.name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                for entry, argtypes in library.entries.items():
                    fn = getattr(lib, entry)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                _loaded[library.name] = lib
    return lib


def launch(library: Library, entry: str, device: torch.device, *args,
           count: str) -> None:
    """Call the CUDA entry ``entry`` of ``library`` with ``args`` and the
    handle of ``device``'s current stream, which every launch entry takes
    last; raise if it returns a CUDA error, else count one launch on the
    counter ``count``."""
    fn = getattr(load(library), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {rc}")
    with _load_count_lock:
        _launches[count] += 1


def launch_counts(reset: bool = False) -> Counter[str]:
    """The kernels' launches since the last reset, by counter (0 for one
    not launched); with ``reset``, every counter starts again from 0.  The
    counters: ``k1``, ``k5``, ``k6``, ``geometry`` and ``exact_tail`` (the
    pooler), ``iou``, ``containment``, ``dedupe``, ``pairs`` and
    ``pairs.write`` (the pairwise relations and their compaction),
    ``relpos.window`` and ``relpos.global`` (ViTDet's attention),
    ``relpos.pooled_window`` and ``relpos.pooled_global`` (MViTv2's),
    ``frozen_norm`` and ``frozen_norm.tail`` (the backbone's norms)."""
    with _load_count_lock:
        counts = collections.Counter(_launches)
        if reset:
            _launches.clear()
    return counts
