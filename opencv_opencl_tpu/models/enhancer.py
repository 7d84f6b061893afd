"""The flagship "model": a configurable NV12 frame-enhancement pipeline.

This is the device equivalent of the reference's worker hot loop
(``OpenCVequalHist.cpp:102-196``): NV12 in -> enhance Y plane (equalizeHist
or CLAHE) -> chroma policy (gray / passthrough) -> NV12 out.  One jitted
function maps a whole *batch* of frames (the data-parallel axis that
replaces the 1-8 worker threads), uint8 end-to-end in device memory.

The enhancement op runs with the same bit-exact OpenCV semantics as the
golden models, so the relay output is indistinguishable from the reference's
(`1frameMeasure.cpp` bar: absdiff <= 1; we hold 0).

Example
-------
>>> cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
...                      chroma=ChromaPolicy.PASSTHROUGH)
>>> enhancer = Enhancer(cfg, FrameSpec(width=1920, height=1080))
>>> out = enhancer.process_batch(nv12_batch)   # uint8 (N, 1620, 1920)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.ops import clahe as clahe_ops
from opencv_opencl_tpu.ops import histeq as histeq_ops

__all__ = ["EnhancerConfig", "Enhancer", "build_enhance_fn",
           "make_enhance_y", "StreamingEnhancer",
           "build_streaming_clahe_fn", "initial_hists"]


@dataclasses.dataclass(frozen=True)
class EnhancerConfig:
    """What to run per frame.

    op: "histeq" (global equalization, OpenCVequalHist family),
        "clahe" (CLAHECompare family), or "none" (pure passthrough relay).
    chroma: GRAY (UV=128) or PASSTHROUGH, the two reference chroma policies.
    hist_method: histogram strategy ("onehot" | "scatter").
    use_ref_frame: two-input mode — LUT from the previous frame's histogram
        (the accel.cpp ref-frame hook) for latency hiding; histeq only.
    """

    op: str = "histeq"
    clip_limit: float = 2.0
    tile_grid: tuple[int, int] = (8, 8)
    chroma: ChromaPolicy = ChromaPolicy.GRAY
    hist_method: str = "onehot"
    use_ref_frame: bool = False  # histeq: batch-internal shift; clahe: use
    #                              StreamingEnhancer (hist carry + fusion)
    # 1 = exact (bit-exact vs cv2, the default).  N > 1 builds histograms
    # from every Nth row with counts rescaled — the opt-in APPROXIMATE
    # throughput mode (selective downsampling, arXiv:1709.04583); mapping
    # stays exact, only the LUT statistics are estimated.
    hist_downsample: int = 1

    def __post_init__(self):
        if self.op not in ("histeq", "clahe", "none"):
            raise ValueError(f"unknown op {self.op!r}")
        if self.hist_downsample < 1:
            raise ValueError("hist_downsample must be >= 1")


def make_enhance_y(cfg: EnhancerConfig, spec: FrameSpec):
    """Build the per-config Y-plane batch enhancement closure.

    Returns ``(enhance_y, plan)`` where ``enhance_y(y: uint8[N, H, W])
    -> uint8[N, H, W]`` is traceable JAX code and ``plan`` is the CLAHE
    plan (None for histeq/none).  Shared by :func:`build_enhance_fn`
    and the fused enhance+encode program
    (models/fused_encode.py) so both compile the identical enhancement
    graph — the bit-exactness contract carries over by construction.
    """
    h = spec.height
    tile_grid = tuple(cfg.tile_grid)
    clip_limit = float(cfg.clip_limit)
    method = cfg.hist_method
    plan = (
        clahe_ops.make_clahe_plan(h, spec.width, clip_limit, tile_grid)
        if cfg.op == "clahe"
        else None
    )

    ds = int(cfg.hist_downsample)
    if ds > 1 and cfg.use_ref_frame:
        # refuse rather than silently run exact: the ref-frame modes
        # carry exact histograms between frames
        raise ValueError(
            "hist_downsample is not supported with use_ref_frame "
            "(the ref-frame hist carry is exact-only)")
    if cfg.op == "clahe" and ds > 1 and plan.tile_h % ds:
        raise ValueError(
            f"hist_downsample={ds} must divide the tile height "
            f"({plan.tile_h} for {h}x{spec.width} grid {tile_grid})")

    def enhance_y(y):
        if cfg.op == "histeq":
            if ds > 1:
                # approximate fast-histogram mode: every ds-th row, counts
                # rescaled; the LUT map itself stays exact
                sub_rows = -(-h // ds)
                total = sub_rows * spec.width * ds

                def one(frame):
                    hist = histeq_ops.hist256(frame[::ds], method) * ds
                    lut = histeq_ops.equalize_lut(hist, total=total)
                    return histeq_ops.apply_lut(frame, lut)

                return jax.vmap(one)(y)
            if cfg.use_ref_frame:
                # LUT of frame i comes from frame i-1 (frame 0 maps itself):
                # the streaming use of the accel.cpp two-input signature.
                ref = jnp.concatenate([y[:1], y[:-1]], axis=0)
                total = h * spec.width

                def one(frame, rframe):
                    lut = histeq_ops.equalize_lut(
                        histeq_ops.hist256(rframe, method), total=total
                    )
                    return histeq_ops.apply_lut(frame, lut)

                return jax.vmap(one)(y, ref)
            return histeq_ops.equalize_hist_batch(y, method=method)
        if cfg.op == "clahe":
            return clahe_ops.clahe_apply(y, plan, method=method,
                                         hist_rowstep=ds)
        return y

    return enhance_y, plan


def build_enhance_fn(cfg: EnhancerConfig, spec: FrameSpec,
                     donate: bool = True):
    """Returns a jitted ``fn(nv12_batch: uint8[N, H*3/2, W]) -> same shape``.

    The whole frame batch is processed in one XLA program: Y-plane slice,
    enhancement, chroma policy and re-concatenation all fuse on device.

    ``donate=True`` donates the input buffer to the output (the shapes and
    dtype match, so XLA aliases them — no second device frame allocation, the
    analogue of the reference's pre-allocated per-worker CL buffers,
    ``OpenCLequalHist.cpp:175-192``).  Callers passing host arrays (the
    FrameFeeder path) are unaffected; callers holding a device array must
    not reuse it after the call.
    """
    h = spec.height
    enhance_y, _ = make_enhance_y(cfg, spec)

    def fn(nv12_batch):
        y = nv12_batch[:, :h, :]
        uv = nv12_batch[:, h:, :]
        y_out = enhance_y(y)
        if cfg.chroma == ChromaPolicy.GRAY:
            uv_out = jnp.full_like(uv, 128)
        else:
            uv_out = uv
        return jnp.concatenate([y_out, uv_out], axis=1)

    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def initial_hists(plan) -> "jnp.ndarray":
    """Stream-start tile histograms: uniform mass (an identity-like LUT) —
    the graceful first-frame stand-in for the previous-frame CDFs."""
    base = plan.tile_area // 256
    hists = np.full((plan.num_tiles, 256), base, np.int32)
    hists[:, 0] += plan.tile_area - base * 256
    return jnp.asarray(hists)


def build_streaming_clahe_fn(cfg: EnhancerConfig, spec: FrameSpec):
    """Ref-frame streaming CLAHE: ``(nv12_batch, prev_hists) ->
    (out_batch, hists)``.

    Frame i is mapped with tile LUTs built from frame i-1's histograms —
    the two-input latency-hiding design of the reference device kernel
    (``accel.cpp:36-40``, host passes a separate hist source) extended to
    CLAHE.  Each scan step interpolates with the carried LUTs and builds
    the next frame's histograms.
    """

    if getattr(cfg, "hist_downsample", 1) != 1:
        raise ValueError(
            "hist_downsample is not supported in the streaming "
            "(ref-frame) mode: its hist carry is exact-only")
    h, w = spec.height, spec.width
    plan = clahe_ops.make_clahe_plan(
        h, w, float(cfg.clip_limit), tuple(cfg.tile_grid))

    def one(hists, frame):
        luts = clahe_ops._luts_from_hists(hists, plan)
        out = clahe_ops._interpolate(frame, luts, plan)
        new_h = clahe_ops._tile_histograms(frame, plan, cfg.hist_method)
        return new_h, out

    def fn(nv12_batch, prev_hists):
        y = nv12_batch[:, :h, :]
        uv = nv12_batch[:, h:, :]
        last_h, y_out = jax.lax.scan(one, prev_hists, y)
        uv_out = (jnp.full_like(uv, 128)
                  if cfg.chroma == ChromaPolicy.GRAY else uv)
        return jnp.concatenate([y_out, uv_out], axis=1), last_h

    return jax.jit(fn, donate_argnums=(0,)), plan


class StreamingEnhancer:
    """Stateful ref-frame CLAHE stream: drop-in ``process_batch`` for the
    FrameFeeder; the histogram state carries across batches (frame 0 of
    the stream uses an identity-like uniform-histogram LUT)."""

    def __init__(self, cfg: EnhancerConfig, spec: FrameSpec):
        if cfg.op != "clahe":
            raise ValueError("StreamingEnhancer is the clahe ref-frame mode")
        self.cfg = cfg
        self.spec = spec
        self._fn, self._plan = build_streaming_clahe_fn(cfg, spec)
        self._hists = initial_hists(self._plan)

    def process_batch(self, nv12_batch) -> jax.Array:
        out, self._hists = self._fn(jnp.asarray(nv12_batch), self._hists)
        return out

    def reset(self) -> None:
        self._hists = initial_hists(self._plan)


class Enhancer:
    """Stateful convenience wrapper: config + spec -> reusable jitted step."""

    def __init__(self, cfg: EnhancerConfig, spec: FrameSpec):
        self.cfg = cfg
        self.spec = spec
        self._fn = build_enhance_fn(cfg, spec)

    def process_batch(self, nv12_batch) -> jax.Array:
        """uint8 (N, H*3/2, W) -> uint8 (N, H*3/2, W), on device."""
        return self._fn(jnp.asarray(nv12_batch))

    def process_frame(self, nv12) -> jax.Array:
        """Single frame (H*3/2, W) convenience (batch of 1 under the hood)."""
        return self.process_batch(jnp.asarray(nv12)[None])[0]

    @functools.cached_property
    def compiled_cost(self):
        """Compile eagerly and return the compiled step (for warmup)."""
        import numpy as np

        dummy = np.zeros(
            (1, self.spec.buffer_rows, self.spec.width), dtype=np.uint8
        )
        return self._fn.lower(dummy).compile()
