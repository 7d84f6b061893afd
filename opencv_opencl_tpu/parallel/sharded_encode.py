"""Multi-device fused enhance+encode: GOP-per-device data parallelism.

The encoder's only sequential dependency is the in-GOP reconstruction
chain — every GOP starts with an IDR whose intra program ignores the
incoming reference planes, so GOPs are INDEPENDENT encode units.  That
makes a single stream data-parallel across chips with byte-identical
output: shard the frame axis over the whole mesh in whole-GOP blocks
and let every device run the same fused enhance+GOP scan
(models/fused_encode.build_enhance_gop_fn) over its own GOPs, starting
from zero recon planes that the IDR branch never reads.  No
collectives at all — the scaling shape is the
reference's worker pool (``/root/reference/OpenCVequalHist.cpp:396-402``)
lifted from threads-over-frames to devices-over-GOPs, which is the
correct granularity for a codec: frames inside a GOP are causally
chained, GOPs are not.

Properties:

- **byte-identical** to the sequential ``TpuGopEncoder`` stream at
  equal qp (asserted in tests/test_sharded_encode.py): the per-device
  program IS the single-chip fused program; the scan crossing a GOP
  boundary is exactly the sequential encoder's behavior because the
  intra branch reads no carry state.
- **stateless steps**: unlike the single-chip fused path there is no
  recon/idx state carried across dispatches, so batch padding is safe
  (pad frames are causally downstream of every real frame's output —
  ``pad_batch_for_mesh`` pads, the caller drops the padded tail).
- the all-intra encoder (``--encoder=tpu`` without gop, unit = 1
  frame) shards the same way; every frame is an independent unit.

Composition limits (refused in apps/relay.py): ``gdr`` has no IDR
boundaries to cut at, and rate control / CPB carry sequential
cross-GOP state — both stay single-chip.  ``deblock``, ``search``,
sub-pel modes, ``refs=2`` and ``bitpack`` all compose (their state is
in-GOP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opencv_opencl_tpu.core.frames import FrameSpec
from opencv_opencl_tpu.models.enhancer import EnhancerConfig
from opencv_opencl_tpu.models.fused_encode import (
    build_enhance_gop_fn, build_enhance_levels_fn)

__all__ = [
    "build_mesh_gop_fn",
    "build_mesh_levels_fn",
    "pad_batch_for_mesh",
    "BandedTpuGopEncoder",
]


def _frame_pspec(mesh: Mesh) -> P:
    """Shard the frame axis over EVERY mesh axis (data and space):
    encode units are independent, so all chips are frame workers —
    there is no spatial collective to ride a separate axis."""
    return P(tuple(mesh.axis_names))


def build_mesh_gop_fn(cfg: EnhancerConfig, spec: FrameSpec, gop: int,
                      mesh: Mesh, search: int = 0, subpel: int = 0,
                      refs: int = 1, deblock: bool = False,
                      bitpack: int = 0, parts: bool = False):
    """Returns ``(fn, sharding, unit)``: a jitted
    ``fn(nv12: uint8[N, H*3/2, W], qp: int32) -> int16[N, mbh, mbw, L]``
    where N must be ``unit * len(mesh.devices)`` whole GOPs per device
    times the device count (``unit == gop``; use
    :func:`pad_batch_for_mesh` for ragged tails), ``sharding`` the
    NamedSharding to ``device_put`` inputs with.

    Each device gets contiguous whole GOPs (frame k lives on device
    ``k // (N / ndev)``) and runs the single-chip fused program; the
    packed level tensor comes back frame-sharded and the host entropy
    stage consumes it in stream order (``TpuGopEncoder
    .encode_from_packed`` — frame_num / idr_pic_id advance host-side
    exactly as in the sequential stream)."""
    raw = build_enhance_gop_fn(cfg, spec, gop, search=search,
                               subpel=subpel, refs=refs,
                               deblock=deblock, gdr=0,
                               bitpack=bitpack, parts=parts,
                               jit=False)
    h16 = -(-spec.height // 16) * 16
    w16 = -(-spec.width // 16) * 16
    pspec = _frame_pspec(mesh)

    def step(frames, qp):
        # zero recon seeds: frame 0 of every device-local block is an
        # IDR ((idx0 + i) % gop == 0 at i = 0), so the P branch never
        # reads them before the first in-GOP reconstruction exists
        r0 = (jnp.zeros((h16, w16), jnp.uint8),
              jnp.zeros((h16 // 2, w16 // 2), jnp.uint8),
              jnp.zeros((h16 // 2, w16 // 2), jnp.uint8))
        if refs > 1:
            r0 = r0 + r0
        packed, *_ = raw(frames, qp, jnp.int32(0), *r0)
        return packed

    sharded = shard_map(step, mesh=mesh, in_specs=(pspec, P()),
                        out_specs=pspec, check_vma=False)
    return (jax.jit(sharded), NamedSharding(mesh, pspec), int(gop))


def build_mesh_levels_fn(cfg: EnhancerConfig, spec: FrameSpec,
                         mesh: Mesh, bitpack: int = 0):
    """All-intra variant (``--encoder=tpu`` without gop): every frame
    is an independent unit, so ``unit == 1``.  Same return contract as
    :func:`build_mesh_gop_fn`."""
    raw = build_enhance_levels_fn(cfg, spec, bitpack=bitpack,
                                  jit=False)
    pspec = _frame_pspec(mesh)
    sharded = shard_map(lambda frames, qp: raw(frames, qp), mesh=mesh,
                        in_specs=(pspec, P()), out_specs=pspec,
                        check_vma=False)
    return (jax.jit(sharded), NamedSharding(mesh, pspec), 1)


def pad_batch_for_mesh(batch: np.ndarray, ndev: int,
                       unit: int) -> tuple[np.ndarray, int]:
    """Pad a frame batch up to a multiple of ``ndev * unit`` frames by
    repeating the last frame; returns ``(padded, real_count)`` — the
    caller emits only the first ``real_count`` packed outputs.

    Safe ONLY because mesh steps are stateless: the pad frames extend
    the final (possibly partial) GOP, and a scan is causal — appended
    frames cannot change the outputs of the real frames before them.
    The single-chip fused path must NOT pad (its recon/idx chain
    persists across dispatches)."""
    n = int(batch.shape[0])
    block = ndev * unit
    want = -(-n // block) * block
    if want == n:
        return batch, n
    pad = np.broadcast_to(batch[-1:], (want - n,) + batch.shape[1:])
    return np.concatenate([batch, pad], axis=0), n


class BandedTpuGopEncoder:
    """Spatially-banded single-stream GOP encoder: ONE frame's MB rows
    are sharded over every mesh device, scaling per-frame LATENCY (the
    GOP-per-device mode above scales throughput but each frame still
    runs on one chip).  This is the round-4 verdict's stretch goal:
    slice-band sharding with an MC-halo exchange.

    Byte-identity by construction, reusing the single-chip programs
    unchanged: every device ``all_gather``s the reference planes over
    the interconnect (the only collective; ~12 MB at 4K), slices a 16-aligned
    WINDOW around its band — the band rows plus ``S16`` halo rows
    covering the motion-search reach and the 6-tap/bilinear
    interpolation support, edge-replicated exactly like the
    full-frame program at picture borders — runs the unchanged
    :func:`~opencv_opencl_tpu.ops.h264_levels.encode_p_levels` (or the
    intra scan) on the window, and CROPS the outputs to its band.
    One slice per MB row makes every per-row computation (intra left
    edge, skip predictor, entropy contexts) band-local, so the crop
    is exact; the halo windows only cost ``2 * S16 / 16`` redundant
    MB rows per device.

    Implementation note: this subclasses nothing but REUSES
    TpuGopEncoder's host entropy machinery by delegation — the banded
    device functions return the same PLevelArrays / LevelArrays
    pytrees (sharded over bands), and numpy fetches gather
    transparently.

    Composition: search >= 1 required (banding exists for the MC
    halo; zero-motion bands are trivially independent through the
    GOP-per-device mode), full/half/quarter-pel, ``parts`` and
    ``refs=2`` compose (both reference reconstructions stay
    band-sharded; the P step all-gathers and halo-windows each);
    gdr / deblock / bitpack / cpb do not (cross-row or per-MB-layout
    state).
    """

    codec = "h264"

    def __init__(self, width: int, height: int, mesh: Mesh,
                 qp: int = 30, gop: int = 30, search: int = 4,
                 halfpel: bool = False, quarterpel: bool = False,
                 parts: bool = False, overlap: bool = False,
                 refs: int = 1) -> None:
        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.ops.h264_levels import (
            encode_levels, encode_p_levels)

        if search < 1:
            raise ValueError("banded encoding requires search=R >= 1")
        self._inner = TpuGopEncoder(width, height, qp=qp, gop=gop,
                                    search=search, halfpel=halfpel,
                                    quarterpel=quarterpel, parts=parts,
                                    overlap=overlap, refs=refs)
        self.mesh = mesh
        axes = tuple(mesh.axis_names)
        nb = len(mesh.devices.flat)
        h16 = -(-height // 16) * 16
        w16 = -(-width // 16) * 16
        mb_h = h16 // 16
        if mb_h % nb:
            raise ValueError(
                f"banded encoding needs MB rows ({mb_h}) divisible by "
                f"the device count ({nb})")
        band_mbs = mb_h // nb
        band_rows = band_mbs * 16
        subpel = self._inner.subpel
        # halo: search reach + 6-tap/bilinear support rows, rounded to
        # whole MB rows so the window stays a valid frame
        s16 = 16 * (-(-(search + (3 if subpel else 0)) // 16))
        self.band_mbs, self.halo_rows = band_mbs, s16
        nspace = mesh.shape[axes[1]] if len(axes) > 1 else 1

        def band_index():
            i = jax.lax.axis_index(axes[0])
            if len(axes) > 1:
                i = i * nspace + jax.lax.axis_index(axes[1])
            return i

        def band_i(y, cb, cr, qp_t):
            a = band_index()
            yw = jax.lax.dynamic_slice(y, (band_rows * a, 0),
                                       (band_rows, w16))
            cbw = jax.lax.dynamic_slice(cb, (band_rows // 2 * a, 0),
                                        (band_rows // 2, w16 // 2))
            crw = jax.lax.dynamic_slice(cr, (band_rows // 2 * a, 0),
                                        (band_rows // 2, w16 // 2))
            return encode_levels(yw, cbw, crw, qp_t, full_recon=True)

        def band_p(y, cb, cr, ryb, rcbb, rcrb, qp_t):
            ry = jax.lax.all_gather(ryb, axes, axis=0, tiled=True)
            rcb = jax.lax.all_gather(rcbb, axes, axis=0, tiled=True)
            rcr = jax.lax.all_gather(rcrb, axes, axis=0, tiled=True)
            a = band_index()

            def win(full, halo, rows):
                padded = jnp.pad(full, ((halo, halo), (0, 0)),
                                 mode="edge")
                return jax.lax.dynamic_slice(
                    padded, (rows * a, 0),
                    (rows + 2 * halo, full.shape[1]))

            yw = win(y, s16, band_rows)
            cbw = win(cb, s16 // 2, band_rows // 2)
            crw = win(cr, s16 // 2, band_rows // 2)
            rw = win(ry, s16, band_rows)
            rcbw = win(rcb, s16 // 2, band_rows // 2)
            rcrw = win(rcr, s16 // 2, band_rows // 2)
            plv = encode_p_levels(yw, cbw, crw, rw, rcbw, rcrw, qp_t,
                                  search, subpel,
                                  parts=1 if parts else 0)
            k = s16 // 16

            def crop_mb(x):
                return None if x is None else x[k:k + band_mbs]

            return type(plv)(
                crop_mb(plv.mode), crop_mb(plv.zdc), crop_mb(plv.acz),
                crop_mb(plv.czdc), crop_mb(plv.cacz),
                plv.recon_y[s16:s16 + band_rows],
                plv.recon_cb[s16 // 2:s16 // 2 + band_rows // 2],
                plv.recon_cr[s16 // 2:s16 // 2 + band_rows // 2],
                crop_mb(plv.mv), crop_mb(plv.ref), crop_mb(plv.pmode))

        def band_p2(y, cb, cr, ryb, rcbb, rcrb, qp_t,
                    ry2b, rcb2b, rcr2b):
            # two references: gather + halo-window BOTH recon sets
            a = band_index()

            def gw(full_b, halo, rows):
                full = jax.lax.all_gather(full_b, axes, axis=0,
                                          tiled=True)
                padded = jnp.pad(full, ((halo, halo), (0, 0)),
                                 mode="edge")
                return jax.lax.dynamic_slice(
                    padded, (rows * a, 0),
                    (rows + 2 * halo, full.shape[1]))

            def winl(full, halo, rows):
                padded = jnp.pad(full, ((halo, halo), (0, 0)),
                                 mode="edge")
                return jax.lax.dynamic_slice(
                    padded, (rows * a, 0),
                    (rows + 2 * halo, full.shape[1]))

            yw = winl(y, s16, band_rows)
            cbw = winl(cb, s16 // 2, band_rows // 2)
            crw = winl(cr, s16 // 2, band_rows // 2)
            rw = gw(ryb, s16, band_rows)
            rcbw = gw(rcbb, s16 // 2, band_rows // 2)
            rcrw = gw(rcrb, s16 // 2, band_rows // 2)
            r2w = gw(ry2b, s16, band_rows)
            rcb2w = gw(rcb2b, s16 // 2, band_rows // 2)
            rcr2w = gw(rcr2b, s16 // 2, band_rows // 2)
            plv = encode_p_levels(yw, cbw, crw, rw, rcbw, rcrw, qp_t,
                                  search, subpel,
                                  ry2=r2w, rcb2=rcb2w, rcr2=rcr2w,
                                  parts=1 if parts else 0)
            k = s16 // 16

            def crop_mb(x):
                return None if x is None else x[k:k + band_mbs]

            return type(plv)(
                crop_mb(plv.mode), crop_mb(plv.zdc), crop_mb(plv.acz),
                crop_mb(plv.czdc), crop_mb(plv.cacz),
                plv.recon_y[s16:s16 + band_rows],
                plv.recon_cb[s16 // 2:s16 // 2 + band_rows // 2],
                plv.recon_cr[s16 // 2:s16 // 2 + band_rows // 2],
                crop_mb(plv.mv), crop_mb(plv.ref), crop_mb(plv.pmode))

        from opencv_opencl_tpu.ops.h264_levels import (LevelArrays,
                                                       PLevelArrays)

        band = P(axes, None)
        band3 = P(axes, None, None)
        band4 = P(axes, None, None, None)
        band5 = P(axes, None, None, None, None)
        lv_spec = (band3, band4, band4, band5)  # zdc, acz, czdc, cacz
        i_out = (LevelArrays(*lv_spec), band, band, band, band)
        p_out = PLevelArrays(
            band, *lv_spec, band, band, band,
            band4 if parts else band3,
            None, band if parts else None)
        self._inner._i_fn = jax.jit(shard_map(
            band_i, mesh=mesh, in_specs=(P(), P(), P(), P()),
            out_specs=i_out, check_vma=False))
        sm_p = shard_map(
            band_p, mesh=mesh,
            in_specs=(P(), P(), P(), band, band, band, P()),
            out_specs=p_out, check_vma=False)
        # search/subpel are closed over; the wrapper keeps the parent
        # _dispatch call shape (it passes them positionally)
        self._inner._p_fn = jax.jit(
            lambda y, cb, cr, ry, rcb, rcr, qp, s, sp: sm_p(
                y, cb, cr, ry, rcb, rcr, qp),
            static_argnums=(7, 8))
        if refs > 1:
            # two-reference P step + the non-donating first-P variant
            p2_out = PLevelArrays(
                band, *lv_spec, band, band, band,
                band4 if parts else band3,
                band3 if parts else band,
                band if parts else None)
            sm_p2 = shard_map(
                band_p2, mesh=mesh,
                in_specs=(P(), P(), P(), band, band, band, P(),
                          band, band, band),
                out_specs=p2_out, check_vma=False)
            self._inner._p2_fn = jax.jit(
                lambda y, cb, cr, ry, rcb, rcr, qp, s, sp, ry2, \
                rcb2, rcr2: sm_p2(y, cb, cr, ry, rcb, rcr, qp,
                                  ry2, rcb2, rcr2),
                static_argnums=(7, 8))
            self._inner._p1_keep_fn = self._inner._p_fn

    # ---- io.encoder protocol: delegate to the (re-wired) inner
    @property
    def gop(self):
        return self._inner.gop

    @property
    def qp(self):
        return self._inner.qp

    def encode(self, nv12) -> list[bytes]:
        return self._inner.encode(nv12)

    def flush(self) -> list[bytes]:
        return self._inner.flush()

    def close(self) -> None:
        self._inner.close()
