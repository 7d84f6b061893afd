"""CLAHE as jitted JAX ops — OpenCV-exact, batched.

The device replacement for ``cv::CLAHE::apply`` on the reference's worker
thread (``CLAHECompare.cpp:143-150``, ``clahe1frame.cpp:88-95``).

Design
------
CLAHE factors into a *plan* (everything derivable from the static geometry:
tile sizes, reflect-101 padding, integer clip limit, per-axis interpolation
indices/weights) and a *jitted apply* over that plan.  The plan's per-axis
arrays are tiny (O(H)+O(W)) and computed in numpy with OpenCV's exact
float32 reciprocal-multiply semantics (see ``core/golden.py``); the 2-D
index fields are rebuilt inside the kernel from the per-axis arrays so
nothing O(H*W) is ever shipped from the host.

The per-tile stage vectorizes over all tiles at once (the tile grid is the
reference's spatial-parallel axis — CLAHE's own N x N decomposition, SURVEY
§2 "tile parallelism"), and batching over frames adds the data-parallel
axis on top.  Histogram cumsums stay in int32 so results are exact under
any XLA reduction order; only the final LUT scale and bilinear blend are
float32, matching OpenCV's own precision.

Bit-exactness: outputs equal ``cv2.createCLAHE(clip, grid).apply`` exactly
(max absdiff 0) on every configuration tested, beating the reference's
accuracy bar of +/-1 LSB (``1frameMeasure.cpp:94-99``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from opencv_opencl_tpu.ops.histogram import tile_histograms

__all__ = ["ClahePlan", "make_clahe_plan", "clahe_apply", "clahe", "CLAHE"]


@dataclasses.dataclass(frozen=True)
class ClahePlan:
    """Static CLAHE geometry + interpolation constants for one frame shape."""

    height: int
    width: int
    tiles_x: int
    tiles_y: int
    clip_limit: float
    tile_h: int          # tile size in the padded image
    tile_w: int
    pad_bottom: int
    pad_right: int
    clip: int            # integer clip limit (0 = no clipping)
    lut_scale: float     # float32 255/tileArea
    # per-axis interpolation constants (numpy, closed over as jit constants)
    ty1: np.ndarray      # int32[H] low tile row
    ty2: np.ndarray      # int32[H] high tile row
    ya: np.ndarray       # float32[H] row fraction
    tx1: np.ndarray      # int32[W]
    tx2: np.ndarray      # int32[W]
    xa: np.ndarray       # float32[W]

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_area(self) -> int:
        return self.tile_h * self.tile_w


def _interp_coords(n: int, tile: int, tiles: int):
    """OpenCV-exact per-pixel tile coordinates: p*(1.0f/tile) - 0.5f in f32."""
    inv = np.float32(1.0) / np.float32(tile)
    f = (np.arange(n, dtype=np.float32) * inv - np.float32(0.5)).astype(np.float32)
    lo = np.floor(f).astype(np.int32)
    frac = (f - lo).astype(np.float32)
    return (
        np.clip(lo, 0, tiles - 1).astype(np.int32),
        np.clip(lo + 1, 0, tiles - 1).astype(np.int32),
        frac,
    )


@functools.lru_cache(maxsize=64)
def make_clahe_plan(
    height: int,
    width: int,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
) -> ClahePlan:
    """Build the static plan for (height, width) frames.

    ``tile_grid`` is (tilesX, tilesY), OpenCV cv::Size argument order.
    """
    tiles_x, tiles_y = tile_grid
    if height % tiles_y == 0 and width % tiles_x == 0:
        pb = pr = 0
    else:
        # OpenCV pads with NO modulo wrap once either dim is non-divisible
        # (a divisible dim still gets a full extra tile) — see golden.py
        pb = tiles_y - height % tiles_y
        pr = tiles_x - width % tiles_x
    tile_h = (height + pb) // tiles_y
    tile_w = (width + pr) // tiles_x
    tile_area = tile_h * tile_w
    clip = max(int(clip_limit * tile_area / 256.0), 1) if clip_limit > 0 else 0
    lut_scale = float(np.float32(255.0) / np.float32(tile_area))
    ty1, ty2, ya = _interp_coords(height, tile_h, tiles_y)
    tx1, tx2, xa = _interp_coords(width, tile_w, tiles_x)
    return ClahePlan(
        height=height, width=width, tiles_x=tiles_x, tiles_y=tiles_y,
        clip_limit=clip_limit, tile_h=tile_h, tile_w=tile_w,
        pad_bottom=pb, pad_right=pr, clip=clip, lut_scale=lut_scale,
        ty1=ty1, ty2=ty2, ya=ya, tx1=tx1, tx2=tx2, xa=xa,
    )


def _extend(y: jax.Array, plan: ClahePlan) -> jax.Array:
    """Reflect-101 extension of the frame to the tile-divisible size."""
    ext = y
    if plan.pad_bottom or plan.pad_right:
        if plan.pad_bottom < plan.height and plan.pad_right < plan.width:
            # numpy/jnp 'reflect' == OpenCV BORDER_REFLECT_101 (no edge repeat)
            ext = jnp.pad(
                y, ((0, plan.pad_bottom), (0, plan.pad_right)), mode="reflect"
            )
        else:
            # pad >= dim (tiles larger than the image): jnp.pad can't
            # multi-reflect — use static OpenCV-equivalent index arrays
            from opencv_opencl_tpu.core.golden import reflect101_indices

            rows = jnp.asarray(
                reflect101_indices(plan.height + plan.pad_bottom, plan.height)
            )
            cols = jnp.asarray(
                reflect101_indices(plan.width + plan.pad_right, plan.width)
            )
            ext = jnp.take(jnp.take(y, rows, axis=0), cols, axis=1)
    return ext


def _tile_histograms(y: jax.Array, plan: ClahePlan, method: str,
                     rowstep: int = 1) -> jax.Array:
    """Per-tile 256-bin histograms, int32[(tilesY*tilesX), 256].

    ``rowstep > 1`` samples every rowstep-th row per tile and scales the
    counts back — the opt-in APPROXIMATE fast-histogram mode (selective
    downsampling, arXiv:1709.04583); rowstep must divide tile_h so every
    tile contributes the same row phase."""
    ext = _extend(y, plan)
    tile_h = plan.tile_h
    if rowstep > 1:
        ext = ext[::rowstep]
        tile_h = plan.tile_h // rowstep
    hists = tile_histograms(ext, plan.tiles_y, plan.tiles_x, tile_h,
                            plan.tile_w, method)
    if rowstep > 1:
        hists = hists * rowstep  # counts approximate the full tile area
    return hists


def _clip_histograms(hists: jax.Array, clip: int) -> jax.Array:
    """OpenCV's single-pass clip + redistribution, vectorized over tiles.

    Excess above the clip limit is floor-shared across all 256 bins and the
    residual handed out one count at a time with stride max(256//residual, 1)
    starting from bin 0 — reproduced here as a closed-form mask.
    """
    clipped = jnp.maximum(hists - clip, 0).sum(axis=1)          # (T,)
    h = jnp.minimum(hists, clip)
    redist = clipped // 256
    residual = clipped - redist * 256                            # in [0, 256)
    h = h + redist[:, None]
    step = jnp.maximum(256 // jnp.maximum(residual, 1), 1)       # (T,)
    bins = jnp.arange(256, dtype=jnp.int32)[None, :]
    bump = (bins % step[:, None] == 0) & (bins // step[:, None] < residual[:, None])
    return h + bump.astype(jnp.int32)


def _luts_from_hists(hists: jax.Array, plan: ClahePlan) -> jax.Array:
    """Per-tile CDF LUTs, uint8[T, 256]."""
    if plan.clip > 0:
        hists = _clip_histograms(hists, plan.clip)
    cdf = jnp.cumsum(hists, axis=1)  # int32: exact
    scaled = cdf.astype(jnp.float32) * jnp.float32(plan.lut_scale)
    return jnp.clip(jnp.rint(scaled), 0, 255).astype(jnp.uint8)


def _blend(l11, l12, l21, l22, xa, xa1, ya, ya1):
    """OpenCV's exact bilinear blend: each f32 product must round to f32
    *before* the adds.  XLA likes to fuse a*b+c into an FMA (one rounding),
    which flips half-way cases like 207.5 by 1 LSB — optimization_barrier
    pins each product so the arithmetic matches OpenCV's mul-then-add."""
    bar = jax.lax.optimization_barrier
    r1 = bar(l11 * xa1) + bar(l12 * xa)
    r2 = bar(l21 * xa1) + bar(l22 * xa)
    res = bar(r1 * ya1) + bar(r2 * ya)
    return jnp.clip(jnp.rint(res), 0, 255).astype(jnp.uint8)


def _interpolate(y: jax.Array, luts: jax.Array, plan: ClahePlan) -> jax.Array:
    """Bilinear blend of the 4 neighbouring tile LUTs at each pixel."""
    tiles_x = plan.tiles_x
    ty1 = jnp.asarray(plan.ty1)[:, None]
    ty2 = jnp.asarray(plan.ty2)[:, None]
    tx1 = jnp.asarray(plan.tx1)[None, :]
    tx2 = jnp.asarray(plan.tx2)[None, :]
    ya = jnp.asarray(plan.ya)[:, None]
    xa = jnp.asarray(plan.xa)[None, :]
    v = y.astype(jnp.int32)
    flat = luts.reshape(-1)  # (T*256,)

    def g(tyr, txc):
        return jnp.take(flat, (tyr * tiles_x + txc) * 256 + v, axis=0).astype(jnp.float32)

    l11, l12, l21, l22 = g(ty1, tx1), g(ty1, tx2), g(ty2, tx1), g(ty2, tx2)
    xa1 = jnp.float32(1.0) - xa
    ya1 = jnp.float32(1.0) - ya
    return _blend(l11, l12, l21, l22, xa, xa1, ya, ya1)


def _interpolate_rows(
    y: jax.Array, luts: jax.Array, plan: ClahePlan, row_start: jax.Array
) -> jax.Array:
    """Like :func:`_interpolate` but for a band of rows starting at the
    (traced) global row index ``row_start`` — the spatially-sharded path,
    where each device owns a horizontal band of the frame."""
    rows_loc = y.shape[-2]

    def band(a):
        # edge-pad by one band so a band that reaches past the frame (pad
        # rows the caller slices away) never clamps the slice start
        a = np.pad(a, (0, rows_loc), mode="edge")
        return jax.lax.dynamic_slice(
            jnp.asarray(a), (row_start,), (rows_loc,))[:, None]

    ty1, ty2, ya = band(plan.ty1), band(plan.ty2), band(plan.ya)
    tx1 = jnp.asarray(plan.tx1)[None, :]
    tx2 = jnp.asarray(plan.tx2)[None, :]
    xa = jnp.asarray(plan.xa)[None, :]
    v = y.astype(jnp.int32)
    flat = luts.reshape(-1)

    def g(tyr, txc):
        return jnp.take(flat, (tyr * plan.tiles_x + txc) * 256 + v, axis=0).astype(jnp.float32)

    l11, l12, l21, l22 = g(ty1, tx1), g(ty1, tx2), g(ty2, tx1), g(ty2, tx2)
    xa1 = jnp.float32(1.0) - xa
    ya1 = jnp.float32(1.0) - ya
    return _blend(l11, l12, l21, l22, xa, xa1, ya, ya1)


def clahe_apply(y: jax.Array, plan: ClahePlan, method: str = "onehot",
                hist_rowstep: int = 1) -> jax.Array:
    """CLAHE one frame (H, W) or a batch (N, H, W) against a prebuilt plan.

    ``method`` is the XLA histogram formulation used where the histogram
    kernel does not run (see :func:`ops.histogram.tile_histograms`).

    hist_rowstep: 1 = exact (the default; bit-exact vs cv2).  N > 1 is
    the opt-in APPROXIMATE fast-histogram mode: per-tile histograms are
    built from every Nth row and the counts rescaled (selective
    downsampling, arXiv:1709.04583) — interpolation stays exact, only
    the LUT statistics are estimated.  Requires tile_h % N == 0.
    """
    if hist_rowstep != 1:
        if hist_rowstep < 1 or plan.tile_h % hist_rowstep:
            raise ValueError(
                f"hist_rowstep={hist_rowstep} must divide tile_h "
                f"({plan.tile_h})")
    if y.ndim == 3:
        return jax.vmap(
            lambda f: clahe_apply(f, plan, method, hist_rowstep))(y)
    hists = _tile_histograms(y, plan, method, rowstep=hist_rowstep)
    luts = _luts_from_hists(hists, plan)
    return _interpolate(y, luts, plan)


@functools.lru_cache(maxsize=64)
def _jitted_apply(height, width, clip_limit, tile_grid, method):
    plan = make_clahe_plan(height, width, clip_limit, tile_grid)
    return jax.jit(lambda y: clahe_apply(y, plan, method))


def clahe(
    y: jax.Array,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
    method: str = "onehot",
) -> jax.Array:
    """One-shot OpenCV-exact CLAHE (jit-cached per frame shape)."""
    h, w = y.shape[-2], y.shape[-1]
    return _jitted_apply(h, w, float(clip_limit), tuple(tile_grid), method)(y)


class CLAHE:
    """cv2.createCLAHE-shaped stateful wrapper (lazy per-shape jit cache).

    Mirrors the reference's lazily-created reusable ``cv::Ptr<cv::CLAHE>``
    (``CLAHECompare.cpp:143-150``): construct once, apply per frame.
    """

    def __init__(self, clip_limit: float = 40.0, tile_grid_size: tuple[int, int] = (8, 8)):
        self.clip_limit = float(clip_limit)
        self.tile_grid_size = tuple(tile_grid_size)

    def apply(self, y, method: str = "onehot"):
        y = jnp.asarray(y)
        return clahe(y, self.clip_limit, self.tile_grid_size, method)

    # cv2 API parity
    def setClipLimit(self, v: float) -> None:
        self.clip_limit = float(v)

    def getClipLimit(self) -> float:
        return self.clip_limit

    def setTilesGridSize(self, v: tuple[int, int]) -> None:
        self.tile_grid_size = tuple(v)

    def getTilesGridSize(self) -> tuple[int, int]:
        return self.tile_grid_size
