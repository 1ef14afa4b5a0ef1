"""A guard for the port's comparisons against the JAX package: its side must
trace contours with its native library, never with its cv2/numpy fallback.

``treedetection_tpu.native.get_lib`` builds ``_td_native.bin`` in place with
g++, under a thread lock only.  Under pytest-xdist every worker imports
``tests/test_native.py``, whose ``skipif`` calls ``get_lib()`` while the
module is collected, so several g++ processes may write the same file at
once.  A worker that loads it half-written sets the module's sticky
``_build_failed``; from then on that worker's JAX package traces contours
with its fallback, which finds other crowns than the native tracer that the
port uses (and has no fallback for).  The JAX package is the reference and
stays as it is, so the guard lives here: the port's tests that drive the JAX
package's Predictor, stitching or ``process_files`` take the ``jax_native``
fixture, which loads the library one process at a time (a file lock),
clears the sticky flag and tries again while another process may still be
writing the file, and fails the test if the library does not load.
"""

import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

RETRIES = 10
RETRY_SLEEP_S = 3.0


def load_jax_native(retries: int = RETRIES, sleep_s: float = RETRY_SLEEP_S):
    """The JAX package's native library, loaded under a lock file in the
    temporary directory; after a failed load (the sticky ``_build_failed``),
    the flag is cleared and the load tried again ``retries`` times,
    ``sleep_s`` apart.  None if it never loads."""
    from treedetection_tpu import native
    path = os.path.join(tempfile.gettempdir(), "treedetection_tpu_native.lock")
    with open(path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            lib = native.get_lib()
            for _ in range(retries):
                if lib is not None:
                    break
                time.sleep(sleep_s)
                native._build_failed = False
                lib = native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@pytest.fixture(scope="module")
def jax_native():
    """Fails a comparison whose JAX side would trace contours with its
    fallback instead of its native library."""
    lib = load_jax_native()
    assert lib is not None, (
        "the JAX package's native library does not load: its contours would "
        "come from the cv2/numpy fallback, not the reference's tracer")
    return lib


def test_guard_restores_the_native_library(monkeypatch):
    """With the sticky ``_build_failed`` forced, the JAX package stays on
    its fallback; the guard's helper clears it and loads the library, and
    the JAX package then traces with it."""
    from treedetection_tpu import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    assert native.get_lib() is None
    lib = load_jax_native(sleep_s=0.0)
    assert lib is not None
    assert native.get_lib() is lib and not native._build_failed
    mask = np.zeros((12, 12), dtype=np.uint8)
    mask[3:9, 2:7] = 1
    rings = native.trace_contours(mask)
    assert len(rings) == 1
    assert sorted(map(tuple, rings[0])) == sorted(
        {(2, 3), (6, 3), (6, 8), (2, 8)})
