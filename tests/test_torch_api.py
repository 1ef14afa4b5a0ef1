"""The port's public surface: every name that the JAX package's top-level
package (``__all__`` and its lazily resolved stage functions) and its
``ops``, ``eval``, ``autolabel`` and ``utils`` packages export resolves in
the port under the same name.  The JAX names are read from the JAX
package's ``__init__.py`` files; the port imports none of them."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "treedetection_tpu"


def _exported(init: Path):
    """Names an ``__init__.py`` binds with module-level ``from ... import``."""
    tree = ast.parse(init.read_text())
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


def _lazy_names(init: Path):
    """The names a package's ``__getattr__`` resolves: the tuple it tests
    ``name in (...)`` against."""
    tree = ast.parse(init.read_text())
    fn, = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name == "__getattr__"]
    names = [elt.value for node in ast.walk(fn)
             if isinstance(node, ast.Compare)
             and isinstance(node.ops[0], ast.In)
             and isinstance(node.comparators[0], ast.Tuple)
             for elt in node.comparators[0].elts]
    assert names
    return sorted(names)


def test_top_level_surface_matches_jax():
    import treedetection_tpu
    import treedetection_tpu_torch as port
    assert sorted(port.__all__) == sorted(treedetection_tpu.__all__)
    for name in treedetection_tpu.__all__:
        assert callable(getattr(port, name)), name
    lazy = _lazy_names(JAX_PKG / "__init__.py")
    assert lazy == sorted(["process_files", "preprocess_files",
                           "predict_tiles", "postprocess_files",
                           "cleanup_files"])
    from treedetection_tpu_torch import detection
    for name in lazy:
        assert getattr(port, name) is getattr(detection, name), name
    with pytest.raises(AttributeError):
        port.no_such_name


# names whose port is not the JAX package's callable: name -> where it is
NOT_CALLABLE = {("ops", "roi_align"): "ops.roi_align.roi_align"}


@pytest.mark.parametrize("package", ["ops", "eval", "autolabel", "utils"])
def test_subpackage_exports_match_jax(package):
    names = _exported(JAX_PKG / package / "__init__.py")
    assert names
    port = importlib.import_module(f"treedetection_tpu_torch.{package}")
    missing = [n for n in names if (package, n) not in NOT_CALLABLE
               and not callable(getattr(port, n, None))]
    assert not missing, f"treedetection_tpu_torch.{package} lacks {missing}"


def test_ops_roi_align_is_the_submodule():
    """The one exception above: the port's ``ops.roi_align`` is the
    submodule of that name, and its ``roi_align`` is the JAX package's
    ``ops.roi_align`` function, on the same arguments."""
    import numpy as np
    import torch
    from treedetection_tpu_torch import ops
    from treedetection_tpu_torch.ops import roi_align as module
    assert ops.roi_align is module and callable(module.level_pool_inputs)
    assert "roi_align" in _exported(JAX_PKG / "ops" / "__init__.py")
    rng = np.random.default_rng(0)
    fmap = torch.from_numpy(rng.standard_normal((9, 11, 3)).astype(
        np.float32))
    boxes = torch.tensor([[0.5, 1.0, 6.0, 7.5], [2.0, 2.0, 9.0, 4.0]])
    from treedetection_tpu.ops import roi_align as jax_roi_align
    assert callable(jax_roi_align)
    out = module.roi_align(fmap, boxes, 4, 1.0).numpy()
    ref = np.asarray(jax_roi_align(fmap.numpy(), boxes.numpy(), 4, 1.0))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
