"""Per-tile 256-bin histograms on the GPU: a Pallas kernel on the Triton route.

Histogramming is the one enhancement stage where a hand-fused kernel
plausibly beats what XLA makes of the plain version: the XLA forms either
compare every pixel against all 256 bins (``ops.histogram.hist256_onehot``)
or write one-hot intermediates to device memory.  This kernel factors each
pixel value into its high and low nibble and counts with one small matrix
product per row segment:

    hist[h, l] = sum_px [v >> 4 == h] * [v & 15 == l]

The two 16-wide one-hots live in registers (fp16; 0/1 is exact), and the
(16, BW) x (BW, 16) product runs on the tensor cores with float32
accumulation.  Every count is an integer below 2^24, so the result is
exact.

Grid: one block per (frame, tile, chunk of ``_ROWS`` tile rows).  A block
walks its rows and ``_BW``-wide column segments in a loop, masking the
columns past the tile edge, and writes its own (16, 16) partial; the
partials are summed outside the kernel.  No atomics, no state carried
between blocks.

The same kernel serves CLAHE's per-tile histograms and equalizeHist's
whole-frame histogram (one tile).  It has no CPU lowering: on the CPU the
callers take the XLA path (``ops.histogram``), and tests run this kernel
with ``interpret=True``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["tile_histograms"]

_ROWS = 16  # tile rows per block
_BW = 256   # pixels per row segment (the dot's contraction depth)


def _kernel(x_ref, out_ref, *, tiles_x: int, tile_h: int, tile_w: int):
    n = pl.program_id(0)
    t = pl.program_id(1)
    c = pl.program_id(2)
    row0 = (t // tiles_x) * tile_h + c * _ROWS
    col0 = (t % tiles_x) * tile_w
    nrows = jnp.minimum(_ROWS, tile_h - c * _ROWS)
    bins = jnp.arange(16, dtype=jnp.int32)
    lanes = jnp.arange(_BW, dtype=jnp.int32)

    def row(r, acc):
        for j in range(pl.cdiv(tile_w, _BW)):  # static: tile_w is static
            cols = j * _BW + lanes
            valid = cols < tile_w
            v = plgpu.load(x_ref.at[n, row0 + r, col0 + cols],
                           mask=valid, other=0).astype(jnp.int32)
            hi = ((bins[:, None] == (v >> 4)[None, :])
                  & valid[None, :]).astype(jnp.float16)      # (16, BW)
            lo = ((v & 15)[:, None] == bins[None, :]).astype(jnp.float16)
            acc += pl.dot(hi, lo)                             # (16, 16) f32
        return acc

    acc = jax.lax.fori_loop(0, nrows, row, jnp.zeros((16, 16), jnp.float32))
    out_ref[...] = acc.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=(
    "tiles_y", "tiles_x", "tile_h", "tile_w", "interpret"))
def tile_histograms(ext: jax.Array, tiles_y: int, tiles_x: int,
                    tile_h: int, tile_w: int,
                    interpret: bool = False) -> jax.Array:
    """Per-tile histograms of tile-divisible frames.

    ``ext`` is uint8 (H, W) or (N, H, W) with H >= tiles_y * tile_h and
    W >= tiles_x * tile_w (pixels past the tile grid are ignored).
    Returns int32 (T, 256) or (N, T, 256), T = tiles_y * tiles_x in
    row-major tile order, bin index ``16 * hi + lo``.
    """
    single = ext.ndim == 2
    x = ext[None] if single else ext
    n = x.shape[0]
    t = tiles_y * tiles_x
    chunks = pl.cdiv(tile_h, _ROWS)
    out = pl.pallas_call(
        functools.partial(_kernel, tiles_x=tiles_x, tile_h=tile_h,
                          tile_w=tile_w),
        out_shape=jax.ShapeDtypeStruct((n * t * chunks * 16, 16), jnp.int32),
        grid=(n, t, chunks),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(
            (16, 16), lambda i, j, k: ((i * t + j) * chunks + k, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="radix_tile_hist",
    )(x)
    hists = out.reshape(n, t, chunks, 256).sum(axis=2)
    return hists[0] if single else hists
