"""JAX CLAHE ops vs cv2.

Contract: the reference accuracy bar is absdiff <= 1 with 0% exceedance
(1frameMeasure.cpp:94-99).  On the GPU the ops are bit-exact (0 LSB against
core/golden, checked by chip_smoke.py).  On the CPU test backend LLVM contracts
the bilinear blend's mul+add into FMAs, which flips rare exact-tie pixels
(e.g. 207.5 vs 207.4999847) by 1 LSB — so here the assertion is the hard
<=1 bar plus a tight mismatch-fraction limit that would catch any real
algorithmic error.
"""

import cv2
import numpy as np
import pytest

from opencv_opencl_tpu.ops import clahe as clahe_ops
from tests.conftest import assert_clahe_close


def _check(y, clip, grid):
    ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(y)
    out = np.asarray(clahe_ops.clahe(y, clip, grid))
    assert_clahe_close(out, ref)


@pytest.mark.parametrize(
    "shape,clip,grid",
    [
        ((128, 128), 40.0, (8, 8)),
        ((128, 128), 2.0, (8, 8)),
        ((135, 241), 2.0, (8, 8)),   # non-divisible: reflect-101 padding
        ((100, 100), 3.0, (4, 4)),
        ((64, 64), 0.0, (8, 8)),     # no clipping
        ((240, 320), 2.0, (8, 8)),
        ((57, 31), 2.0, (8, 8)),
        ((144, 256), 4.0, (3, 5)),   # asymmetric grid
    ],
)
def test_clahe_exact(rng, shape, clip, grid):
    y = rng.integers(0, 256, shape, dtype=np.uint8)
    _check(y, clip, grid)


def test_clahe_structured(rng):
    base = np.linspace(0, 255, 256, dtype=np.float32)[None, :]
    y = np.clip(base + rng.normal(0, 10, (144, 256)), 0, 255).astype(np.uint8)
    _check(y, 2.0, (8, 8))


def test_clahe_1080p_reference_configs(hun_y):
    """BASELINE.md config 2: both reference parameter points on 1080p."""
    _check(hun_y, 2.0, (8, 8))
    _check(hun_y, 3.0, (4, 4))


def test_clahe_batch(rng):
    batch = rng.integers(0, 256, (3, 96, 128), dtype=np.uint8)
    plan = clahe_ops.make_clahe_plan(96, 128, 2.0, (8, 8))
    out = np.asarray(clahe_ops.clahe_apply(batch, plan))
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for i in range(3):
        assert_clahe_close(out[i], c.apply(batch[i]))


def test_clahe_scatter_method(rng):
    y = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    out = np.asarray(clahe_ops.clahe(y, 2.0, (8, 8), method="scatter"))
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(y)
    assert_clahe_close(out, ref)


def test_clahe_cv2_shaped_api(rng):
    y = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    c = clahe_ops.CLAHE(clip_limit=2.5, tile_grid_size=(4, 4))
    assert c.getClipLimit() == 2.5
    out = np.asarray(c.apply(y))
    ref = cv2.createCLAHE(clipLimit=2.5, tileGridSize=(4, 4)).apply(y)
    assert_clahe_close(out, ref)


def test_plan_caching():
    p1 = clahe_ops.make_clahe_plan(64, 64, 2.0, (8, 8))
    p2 = clahe_ops.make_clahe_plan(64, 64, 2.0, (8, 8))
    assert p1 is p2


def test_clahe_1x1_grid(rng):
    """Degenerate 1x1 tile grid (single global tile)."""
    y = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    _check(y, 2.0, (1, 1))


def test_clahe_huge_clip_no_clipping(rng):
    """Clip limit above any bin count: behaves like plain AHE."""
    y = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    _check(y, 1e6, (4, 4))


def test_clahe_pallas_odd_1080p_slice(rng):
    """An odd-size frame slice (reflect padding in the LUT stage,
    original-size interpolation)."""
    from tests.conftest import assert_clahe_close

    y = rng.integers(0, 256, (135, 241), dtype=np.uint8)
    out = np.asarray(clahe_ops.clahe(y, 2.0, (8, 8)))
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(y)
    assert_clahe_close(out, ref)
