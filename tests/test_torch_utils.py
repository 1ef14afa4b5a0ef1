"""The port's utilities against the JAX package's: stage timing, progress
lines, the NDVI debug raster; and the Predictor's ``profile_dir`` trace."""

import json
import logging
import types

import numpy as np
import pytest

from treedetection_tpu.utils import profiling as jprof
from treedetection_tpu_torch.utils import profiling as tprof


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelno, record.getMessage()))


def _logger(name):
    log = logging.getLogger(name)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    log.handlers = [_Lines()]
    return log


def _timed_spans(module, monkeypatch):
    """Three spans (one twice, one raising) on a clock that steps through a
    fixed sequence -> (summary, log lines, spans)."""
    clock = iter([0.0, 1.25, 2.0, 2.5, 3.0, 7.0, 8.0, 8.5])
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(time=lambda: next(clock)))
    log = _logger(f"stage_timer_{module.__name__}")
    timer = module.StageTimer(log)
    with timer.span("decode"):
        pass
    with timer.span("forward"):
        pass
    with pytest.raises(ValueError):
        with timer.span("stitch"):
            raise ValueError("boom")
    with timer.span("decode"):
        pass
    monkeypatch.undo()
    return timer.summary(), log.handlers[0].lines, timer.spans


def test_stage_timer_matches_jax(monkeypatch):
    want = _timed_spans(jprof, monkeypatch)
    got = _timed_spans(tprof, monkeypatch)
    assert got == want
    assert got[2] == {"decode": 1.75, "forward": 0.5, "stitch": 4.0}
    assert tprof.StageTimer().summary() == jprof.StageTimer().summary()


@pytest.mark.parametrize("total,every", [(7, 5), (100, 5), (250, 10),
                                         (3, 50), (0, 5)])
def test_log_progress_matches_jax(total, every):
    lines = []
    for module in (jprof, tprof):
        log = _logger(f"progress_{module.__name__}")
        for done in range(total + 1):
            module.log_progress(log, done, total, "tiles", every)
        module.log_progress(None, 1, total, "tiles", every)
        lines.append(log.handlers[0].lines)
    assert lines[0] == lines[1]
    assert len(lines[1]) == (0 if total == 0 else
                             len({d for d in range(total + 1)
                                  if d % max(1, total * every // 100) == 0
                                  or d == total}))


def test_profile_trace_is_a_no_op_without_a_directory(tmp_path):
    with tprof.profile_trace(None):
        pass
    with tprof.profile_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []


def test_predictor_writes_a_trace_under_profile_dir(tmp_raster, tmp_path):
    """A Predictor pass with ``profile_dir`` writes one non-empty Chrome
    trace there; the same pass without it writes none, and both write the
    same tile files."""
    from treedetection_tpu_torch.prediction import Predictor
    from treedetection_tpu_torch.preprocessing import tile_single_file
    meta = tile_single_file(tmp_raster["rgb"], str(tmp_path / "tiles"),
                            buffer=20, tile_width=50, tile_height=50)
    cfg = {"device": "cpu", "model_depth": 50, "model_input_size": 64,
           "rpn_pre_nms_topk": 50, "rpn_post_nms_topk": 20,
           "max_detections": 5, "batch_size": 2, "num_workers": 1}
    files = {}
    for name, extra in (("plain", {}),
                        ("profiled", {"profile_dir": str(tmp_path / "prof")})):
        pred = Predictor({**cfg, **extra}, None)
        out = tmp_path / name
        assert pred(tmp_raster["rgb"], meta, str(out)) == 4
        files[name] = {p.name: p.read_bytes()
                       for p in out.glob("Prediction_*.json")}
    assert len(files["plain"]) == 4 and files["plain"] == files["profiled"]
    traces = list((tmp_path / "prof").iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json"
    trace = json.loads(traces[0].read_text())
    assert trace["traceEvents"]
    assert not (tmp_path / "plain" / "prof").exists()


@pytest.mark.parametrize("scaling", [1.0, 0.5])
def test_ndvi_debug_geotiff_matches_jax(tmp_raster, tmp_path, scaling):
    """``write_ndvi_debug(plot=False)``: the same GeoTIFF as the JAX
    package's, pixel for pixel within 1e-6 and with the same header."""
    from treedetection_tpu.geo import GeoTiff
    from treedetection_tpu.utils.ndvi_debug import write_ndvi_debug as jndvi
    from treedetection_tpu_torch.utils.ndvi_debug import (
        write_ndvi_debug as tndvi)
    want, wpng = jndvi(tmp_raster["rgb"], str(tmp_path / "jax"),
                       scaling_factor=scaling, plot=False)
    got, gpng = tndvi(tmp_raster["rgb"], str(tmp_path / "port"),
                      scaling_factor=scaling, plot=False, device="cpu")
    assert wpng is None and gpng is None
    with GeoTiff(want) as w, GeoTiff(got) as g:
        assert (g.width, g.height, g.count, g.crs, g.nodata) == \
            (w.width, w.height, w.count, w.crs, w.nodata)
        assert tuple(g.transform) == tuple(w.transform)
        a, b = w.read()[..., 0], g.read()[..., 0]
    assert a.shape == (int(500 * scaling),) * 2
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    if scaling == 1.0:
        rgbi = tmp_raster["rgbi"].astype(np.float64)
        r, nir = rgbi[..., 0] / 255.0, rgbi[..., 3] / 255.0
        np.testing.assert_allclose(b, (nir - r) / (nir + r + 1e-7),
                                   rtol=0, atol=1e-6)


def test_ndvi_debug_plot_and_band_check(tmp_raster, tmp_path):
    pytest.importorskip("matplotlib")
    from treedetection_tpu_torch.geo import write_geotiff
    from treedetection_tpu_torch.utils.ndvi_debug import write_ndvi_debug
    tif, png = write_ndvi_debug(tmp_raster["rgb"], str(tmp_path), plot=True,
                                device="cpu")
    assert tif.endswith("324125317_ndvi.tif") and png.endswith(".png")
    assert (tmp_path / "324125317_ndvi.png").stat().st_size > 0
    rgb = tmp_path / "rgb3.tif"
    write_geotiff(str(rgb), tmp_raster["rgbi"][..., :3],
                  tmp_raster["transform"], crs=25832)
    with pytest.raises(ValueError, match="NDVI needs RGBI"):
        write_ndvi_debug(str(rgb), str(tmp_path), device="cpu")
