"""Build the port's native libraries from the sources in this package.

Every shared library (the host C++ helpers under ``native/`` and the CUDA
kernels under ``csrc/``) is compiled at first use into ``_build/`` beside this
file, named by a hash of its sources, the headers they include from their own
directory and the compiler command, so an edited source or header always
rebuilds and a stale binary is never loaded.  The compile writes to a
temporary name and renames it into place, which keeps concurrent builders
(test workers, threads) from loading a half-written file.  A failed build
raises: there is no fallback library.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"

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
