"""Image-adaptive CLAHE (extension beyond the reference feature set).

The reference uses a fixed, operator-chosen clip limit.  Retrieved work on
adaptive clip estimation (PAPERS.md: "IA-CLAHE: Image-Adaptive Clip Limit
Estimation for CLAHE") motivates choosing the clip limit per frame from the
luma statistics: flat, low-contrast content amplifies noise under an
aggressive clip, while already-contrasty content tolerates (and benefits
from) more equalization headroom.

This module implements a deterministic, jittable estimator (an original
formulation, not a reproduction of any paper):

    clip(y) = clip_min + (clip_max - clip_min) * H(y) / 8

where H(y) is the Shannon entropy (bits) of the global 256-bin luma
histogram.  Entropy near 8 (rich content) permits the aggressive end;
entropy near 0 (flat content) degenerates toward clip_min (minimal
redistribution).  The whole CLAHE then runs with the *traced* clip value —
unlike the plan-static path, the limit can change every frame at no
recompile cost.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opencv_opencl_tpu.ops import histogram as hist_ops
from opencv_opencl_tpu.ops.clahe import (
    ClahePlan,
    _clip_histograms,
    _interpolate,
    _tile_histograms,
    make_clahe_plan,
)

__all__ = ["estimate_clip_limit", "clahe_auto"]


def estimate_clip_limit(
    y: jax.Array, clip_min: float = 1.0, clip_max: float = 4.0
) -> jax.Array:
    """Entropy-scaled clip limit in [clip_min, clip_max] (f32 scalar)."""
    hist = hist_ops.hist256(y).astype(jnp.float32)
    p = hist / jnp.float32(y.size)
    h = -jnp.sum(jnp.where(p > 0, p * jnp.log2(jnp.maximum(p, 1e-12)), 0.0))
    t = jnp.clip(h / jnp.float32(8.0), 0.0, 1.0)
    return jnp.float32(clip_min) + (jnp.float32(clip_max) - jnp.float32(clip_min)) * t


def _luts_with_traced_clip(hists: jax.Array, plan: ClahePlan,
                           clip_limit: jax.Array) -> jax.Array:
    """Per-tile LUTs with a runtime clip limit (OpenCV clip semantics with
    the integer clip computed from the traced value)."""
    clip = jnp.maximum(
        (clip_limit * plan.tile_area / 256.0).astype(jnp.int32), 1
    )
    hists = _clip_histograms(hists, clip)
    cdf = jnp.cumsum(hists, axis=1)
    scaled = cdf.astype(jnp.float32) * jnp.float32(plan.lut_scale)
    return jnp.clip(jnp.rint(scaled), 0, 255).astype(jnp.uint8)


@functools.lru_cache(maxsize=32)
def _jitted_auto(height, width, tile_grid, clip_min, clip_max, method):
    plan = make_clahe_plan(height, width, 40.0, tile_grid)

    def one(y):
        clip = estimate_clip_limit(y, clip_min, clip_max)
        hists = _tile_histograms(y, plan, method)
        luts = _luts_with_traced_clip(hists, plan, clip)
        return _interpolate(y, luts, plan), clip

    def fn(y):
        if y.ndim == 3:
            return jax.vmap(one)(y)
        return one(y)

    return jax.jit(fn)


def clahe_auto(
    y: jax.Array,
    tile_grid: tuple[int, int] = (8, 8),
    clip_min: float = 1.0,
    clip_max: float = 4.0,
    method: str = "onehot",
):
    """CLAHE with a per-frame adaptive clip limit.

    Returns ``(enhanced, clip_used)``; for batches, ``clip_used`` is per
    frame.  The clip limit never triggers a recompile (traced value).
    """
    h, w = y.shape[-2], y.shape[-1]
    return _jitted_auto(h, w, tuple(tile_grid), float(clip_min),
                        float(clip_max), method)(y)
