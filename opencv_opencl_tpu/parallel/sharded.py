"""Multi-device sharded enhancement: frame DP x spatial row-band sharding.

The scaling story (SURVEY §2 parallelism table -> a device mesh):

- **data** axis: the batch of frames is sharded across devices — each
  device enhances its own frames end-to-end, no communication (the
  perfect-scaling analogue of the reference's worker pool).
- **space** axis: each frame's rows are split into horizontal bands.
  Histogram equalization needs one *global* histogram -> ``psum`` over the
  space axis (256 int32 = 1 KB).  CLAHE's per-tile
  histograms are band-local (bands own whole tile rows), and the bilinear
  blend needs neighbour tiles' LUTs -> a tiled ``all_gather`` of the
  per-band tile histograms (~tiny), after which LUT construction is
  replicated math and interpolation is band-local.  Both collectives are
  <100 KB at 4K; the pixel data never moves between devices.

**Arbitrary geometry** (round-2 generalization — round 1 required
tile-divisible frames and tiles_y % space == 0):

1. the frame is reflect-extended to the tile-divisible size exactly as the
   single-chip plan prescribes (OpenCV semantics), then zero-padded with
   FAKE tile rows up to a space-divisible tile count.  Fake tiles produce
   LUTs no real pixel ever references (the interpolation clip pattern only
   reaches real tiles), so bands can own whole tile rows on any mesh.
2. the interpolation runs over the frame padded to space-divisible rows;
   pad rows compute garbage that is sliced off after the shard_map.
3. both pads are applied inside jit with sharding constraints, so XLA
   inserts the (boundary-only) resharding collectives itself.

The in-band compute is the single-device path (``ops.histogram
.tile_histograms`` + ``ops.clahe._interpolate_rows``).  On the GPU the
histograms come from a Pallas kernel, which under shard_map requires
``check_vma=False`` (pallas out_shapes carry no varying-manual-axes
annotation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from opencv_opencl_tpu.core.frames import ChromaPolicy
from opencv_opencl_tpu.models.enhancer import EnhancerConfig
from opencv_opencl_tpu.ops import clahe as clahe_ops
from opencv_opencl_tpu.ops import histeq as histeq_ops
from opencv_opencl_tpu.ops import histogram as hist_ops

__all__ = [
    "input_sharding",
    "sharded_histeq",
    "sharded_clahe",
    "build_sharded_pipeline",
    "ShardedEnhancer",
]

def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_rows(x: jax.Array, rows: int) -> jax.Array:
    """Zero-pad dim -2 up to ``rows`` (batched)."""
    cur = x.shape[-2]
    if cur == rows:
        return x
    return jnp.pad(x, ((0, 0), (0, rows - cur), (0, 0)))


# ---------------------------------------------------------------- histeq ----


def input_sharding(mesh: Mesh, height: int,
                   data_axis: str = "data",
                   space_axis: str = "space") -> NamedSharding:
    """The NamedSharding callers should place (N, rows, W) inputs with:
    row-banded when the height divides the space axis, else batch-only."""
    nsp = mesh.shape[space_axis]
    spec = (P(data_axis, space_axis, None) if height % nsp == 0
            else P(data_axis, None, None))
    return NamedSharding(mesh, spec)


def sharded_histeq(mesh: Mesh, height: int, width: int,
                   method: str = "onehot",
                   data_axis: str = "data", space_axis: str = "space"):
    """Jitted (N, H, W) -> (N, H, W) equalizeHist over a (data, space) mesh
    (place inputs with :func:`input_sharding`).

    Any height: rows are zero-padded to a space multiple; the pad pixels'
    bin-0 counts are subtracted after the psum (a static constant)."""
    nsp = mesh.shape[space_axis]
    total = height * width
    hq = _ceil_to(height, nsp)
    pad_zeros = (hq - height) * width
    spec_band = P(data_axis, space_axis, None)

    def band_fn(y):  # (B_loc, rows_loc, W)
        def one(f):
            local = hist_ops.hist256(f, method)
            ghist = jax.lax.psum(local, space_axis)
            if pad_zeros:
                ghist = ghist.at[0].add(-pad_zeros)
            lut = hist_ops.equalize_lut(ghist, total=total)
            return histeq_ops.apply_lut(f, lut)
        return jax.vmap(one)(y)

    fn_band = shard_map(band_fn, mesh=mesh, in_specs=(spec_band,),
                        out_specs=spec_band, check_vma=False)

    @jax.jit
    def fn(y):
        y_q = jax.lax.with_sharding_constraint(
            _pad_rows(y, hq), NamedSharding(mesh, spec_band))
        out = fn_band(y_q)
        return out[:, :height, :]

    return fn


# ----------------------------------------------------------------- clahe ----


def _clahe_geometry(plan: clahe_ops.ClahePlan, nsp: int):
    """Static padded-grid geometry for a (space=nsp) mesh."""
    tiles_yp = _ceil_to(plan.tiles_y, nsp)
    hp = tiles_yp * plan.tile_h              # hist-stage padded rows
    hq = _ceil_to(plan.height, nsp)          # interp-stage padded rows
    return tiles_yp, hp, hq


def _build_clahe_fns(plan: clahe_ops.ClahePlan, mesh: Mesh,
                     data_axis: str, space_axis: str):
    nsp = mesh.shape[space_axis]
    tiles_yp, hp, hq = _clahe_geometry(plan, nsp)
    tiles_loc = tiles_yp // nsp
    rows_loc = hq // nsp
    t_real = plan.tiles_y * plan.tiles_x
    spec_band = P(data_axis, space_axis, None)
    spec_rep = P(data_axis, None, None)

    def hist_band(ext_p):  # (B_loc, hp/nsp, We) -> (B_loc, T', 256)
        def one(band):
            hloc = hist_ops.tile_histograms(
                band, tiles_loc, plan.tiles_x, plan.tile_h, plan.tile_w)
            return jax.lax.all_gather(hloc, space_axis, axis=0, tiled=True)
        return jax.vmap(one)(ext_p)

    def interp_band(y_band, luts):  # (B_loc, rows_loc, W), (B_loc, T, 256)
        row0 = jax.lax.axis_index(space_axis) * rows_loc
        return jax.vmap(
            lambda f, l: clahe_ops._interpolate_rows(f, l, plan, row0)
        )(y_band, luts)

    sm_hist = shard_map(hist_band, mesh=mesh, in_specs=(spec_band,),
                        out_specs=spec_rep, check_vma=False)
    sm_interp = shard_map(interp_band, mesh=mesh,
                          in_specs=(spec_band, spec_rep),
                          out_specs=spec_band, check_vma=False)

    def clahe_y(y):  # (B, H, W) -> (B, H, W), inside jit
        ext = jax.vmap(lambda f: clahe_ops._extend(f, plan))(y)
        ext_p = jax.lax.with_sharding_constraint(
            _pad_rows(ext, hp), NamedSharding(mesh, spec_band))
        hists = sm_hist(ext_p)                     # (B, T', 256) replicated
        luts = jax.vmap(
            lambda h: clahe_ops._luts_from_hists(h[:t_real], plan)
        )(hists)                                   # (B, T, 256)
        y_q = jax.lax.with_sharding_constraint(
            _pad_rows(y, hq), NamedSharding(mesh, spec_band))
        out = sm_interp(y_q, luts)
        return out[:, : plan.height, :]

    spec_in = (P(data_axis, space_axis, None)
               if plan.height % nsp == 0 else P(data_axis, None, None))
    return clahe_y, NamedSharding(mesh, spec_in)


def sharded_clahe(mesh: Mesh, plan: clahe_ops.ClahePlan,
                  method: str = "onehot",
                  data_axis: str = "data", space_axis: str = "space"):
    """Jitted (N, H, W) -> (N, H, W) CLAHE over a (data, space) mesh.

    Works for ANY frame geometry, tile grid, and space-axis size (see the
    module docstring for the padded-grid scheme)."""
    clahe_y, _ = _build_clahe_fns(plan, mesh, data_axis, space_axis)
    return jax.jit(clahe_y)


# ----------------------------------------------------------- full pipeline ----


def build_sharded_pipeline(cfg: EnhancerConfig, height: int, width: int,
                           mesh: Mesh,
                           data_axis: str = "data", space_axis: str = "space"):
    """The full multi-chip NV12 step: (y, uv) batches in, enhanced out.

    Returns ``(fn, y_sharding)``; place the uv batch with the same
    NamedSharding (its height is H/2 — when that is not space-divisible
    place it with P(data, None, None); the fn only applies the elementwise
    chroma policy to it, so any placement is correct).
    """
    nsp = mesh.shape[space_axis]
    total = height * width

    if getattr(cfg, "hist_downsample", 1) != 1:
        raise ValueError(
            "hist_downsample is not supported on the sharded path "
            "(the banded histogram stages are exact-only); drop --mesh "
            "or use the exact mode")

    if cfg.op == "clahe":
        plan = clahe_ops.make_clahe_plan(
            height, width, float(cfg.clip_limit), tuple(cfg.tile_grid))
        clahe_y, y_sharding = _build_clahe_fns(
            plan, mesh, data_axis, space_axis)

        @jax.jit
        def fn(y, uv):
            y_out = clahe_y(y)
            uv_out = (jnp.full_like(uv, 128)
                      if cfg.chroma == ChromaPolicy.GRAY else uv)
            return y_out, uv_out

        return fn, y_sharding

    if cfg.op == "histeq":
        histeq_fn = sharded_histeq(
            mesh, height, width, cfg.hist_method, data_axis, space_axis)
        y_sharding = input_sharding(mesh, height, data_axis, space_axis)

        @jax.jit
        def fn(y, uv):
            y_out = histeq_fn(y)
            uv_out = (jnp.full_like(uv, 128)
                      if cfg.chroma == ChromaPolicy.GRAY else uv)
            return y_out, uv_out

        return fn, y_sharding

    spec_in = (P(data_axis, space_axis, None)
               if height % nsp == 0 else P(data_axis, None, None))

    @jax.jit
    def fn(y, uv):
        uv_out = (jnp.full_like(uv, 128)
                  if cfg.chroma == ChromaPolicy.GRAY else uv)
        return y, uv_out

    return fn, NamedSharding(mesh, spec_in)


class ShardedEnhancer:
    """Drop-in multi-device replacement for ``models.enhancer.Enhancer``:
    the same ``process_batch(nv12_batch) -> nv12_batch`` surface the
    FrameFeeder drives, with the batch sharded over the ``data`` axis and
    each frame's rows banded over ``space`` (collectives per the module
    docstring).  The relay exposes it as ``--mesh=auto`` / ``--mesh=DxS``
    — the multi-device analogue of the reference's ``--workers`` scaling
    (``OpenCLequalHist.cpp`` worker pool).

    The batch size must be a multiple of the mesh's data axis (each device
    owns whole frames).
    """

    def __init__(self, cfg: EnhancerConfig, spec, mesh: Mesh | None = None,
                 shape: tuple[int, int] | None = None):
        from opencv_opencl_tpu.parallel.mesh import make_mesh

        self.cfg = cfg
        self.spec = spec
        self.mesh = mesh if mesh is not None else make_mesh(shape=shape)
        self.h, self.w = spec.height, spec.width
        self._fn, self._y_sharding = build_sharded_pipeline(
            cfg, self.h, self.w, self.mesh)
        # uv is elementwise-only: batch-sharded placement is always valid
        self._uv_sharding = NamedSharding(self.mesh, P("data", None, None))

    def process_batch(self, nv12_batch):
        x = jnp.asarray(nv12_batch)
        n = x.shape[0]
        ndata = self.mesh.shape["data"]
        if n % ndata:
            raise ValueError(
                f"batch {n} not divisible by mesh data axis {ndata}")
        y = jax.device_put(x[:, : self.h, :], self._y_sharding)
        uv = jax.device_put(x[:, self.h :, :], self._uv_sharding)
        y_out, uv_out = self._fn(y, uv)
        return jnp.concatenate(
            [y_out, uv_out.astype(y_out.dtype)], axis=1)

    def process_frame(self, nv12):
        return self.process_batch(jnp.asarray(nv12)[None])[0]
