"""Jittable 256-bin histogram + OpenCV-exact equalization LUTs (JAX).

On the GPU every histogram (whole frames and CLAHE tiles alike) comes from
the radix-16 Pallas kernel (``ops/pallas/radix_hist.py``).  That kernel has
no CPU lowering, so on the CPU the XLA formulations below run instead,
selected by ``method``:

- ``hist256_onehot`` — chunked compare-against-iota + reduction (a one-hot
  sum XLA fuses into compare+add without materializing the one-hot),
  mirroring how the reference's HLS kernel streams pixels through a
  histogram stage (``accel.cpp:53-60``).
- ``hist256_scatter`` — a single scatter-add (``.at[y].add(1)``).

LUT construction reproduces cv::equalizeHist exactly (see
``core/golden.py``): integer cumulative sums (bit-exact — no float
accumulation order issues), float32 scale ``255/(total - hist[first])`` (the
same precision OpenCV uses), round-half-to-even, and the constant-image
identity case.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opencv_opencl_tpu.ops.pallas import radix_hist

__all__ = [
    "hist256",
    "hist256_onehot",
    "hist256_scatter",
    "tile_histograms",
    "uses_hist_kernel",
    "equalize_lut",
]

_CHUNK = 1 << 15  # pixels per scan step for the one-hot strategy


def _flatten_px(y: jax.Array) -> jax.Array:
    return y.reshape(-1).astype(jnp.int32)


def hist256_onehot(y: jax.Array) -> jax.Array:
    """256-bin histogram via chunked compare+reduce. Returns int32[256].

    Pixels are processed in static-size chunks under ``lax.scan`` so the
    one-hot working set stays bounded at any resolution; padding pixels are
    set to 256, which matches no bin.
    """
    flat = _flatten_px(y)
    n = flat.size
    # small inputs (e.g. CLAHE tiles) get a right-sized single chunk instead
    # of padding up to the full streaming chunk — 27x less work at 240p tiles
    chunk = min(_CHUNK, max(256, -(-n // 256) * 256))
    pad = (-n) % chunk
    if pad:
        flat = jnp.pad(flat, (0, pad), constant_values=256)
    chunks = flat.reshape(-1, chunk)
    bins = jnp.arange(256, dtype=jnp.int32)

    def step(h, c):
        oh = (c[:, None] == bins[None, :]).astype(jnp.int32)
        return h + oh.sum(axis=0), None

    # derive the zero carry from the data so it carries the same
    # varying-manual-axes type under shard_map (a plain jnp.zeros would be
    # unvarying and fail the scan carry type check on a mesh)
    zero = jnp.zeros(256, jnp.int32) + (chunks[0, 0] * 0)
    h, _ = jax.lax.scan(step, zero, chunks)
    return h


def hist256_scatter(y: jax.Array) -> jax.Array:
    """256-bin histogram via scatter-add. Returns int32[256]."""
    flat = _flatten_px(y)
    return jnp.zeros(256, jnp.int32).at[flat].add(1)


def uses_hist_kernel() -> bool:
    """Whether histograms come from the radix Pallas kernel: it is compiled
    through Triton, which exists only for the GPU."""
    return jax.default_backend() == "gpu"


_XLA_METHODS = {"onehot": hist256_onehot, "scatter": hist256_scatter}


def _xla_method(method: str):
    try:
        return _XLA_METHODS[method]
    except KeyError:
        raise ValueError(f"unknown histogram method {method!r}") from None


def hist256(y: jax.Array, method: str = "onehot") -> jax.Array:
    """256-bin histogram of a uint8 array, int32[256].  ``method`` picks
    the XLA formulation where the kernel does not run."""
    xla_hist = _xla_method(method)
    if uses_hist_kernel() and y.ndim == 2:
        return radix_hist.tile_histograms(y, 1, 1, *y.shape)[0]
    return xla_hist(y)


def tile_histograms(ext: jax.Array, tiles_y: int, tiles_x: int,
                    tile_h: int, tile_w: int,
                    method: str = "onehot") -> jax.Array:
    """Per-tile histograms of a tile-divisible (tiles_y*tile_h,
    tiles_x*tile_w) image, int32 (T, 256) in row-major tile order."""
    xla_hist = _xla_method(method)
    if uses_hist_kernel():
        return radix_hist.tile_histograms(ext, tiles_y, tiles_x, tile_h,
                                          tile_w)
    tiles = (
        ext.reshape(tiles_y, tile_h, tiles_x, tile_w)
        .transpose(0, 2, 1, 3)
        .reshape(tiles_y * tiles_x, tile_h * tile_w)
    )
    return jax.vmap(xla_hist)(tiles)


@functools.partial(jax.jit, static_argnames=("total",))
def equalize_lut(hist: jax.Array, total: int) -> jax.Array:
    """cv::equalizeHist LUT from an int histogram — OpenCV-exact.

    ``total`` is the static pixel count (image size is static under jit).
    """
    hist = hist.astype(jnp.int32)
    first = jnp.argmax(hist > 0).astype(jnp.int32)
    hfirst = hist[first]
    cum = jnp.cumsum(hist)  # integer cumsum: exact, order-independent
    cum_excl = (cum - cum[first]).astype(jnp.float32)
    # OpenCV: float scale = 255.f/(total - hist[i]) — keep f32 like OpenCV.
    denom = jnp.maximum(total - hfirst, 1).astype(jnp.float32)
    scale = jnp.float32(255.0) / denom
    lut = jnp.clip(jnp.rint(cum_excl * scale), 0, 255).astype(jnp.uint8)
    identity = jnp.arange(256, dtype=jnp.uint8)
    # constant image (all mass in one bin) -> identity map (OpenCV copies src)
    return jnp.where(hfirst == total, identity, lut)
