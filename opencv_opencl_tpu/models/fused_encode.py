"""Fused enhance + H.264 level computation: one device program.

The relay's device-encoder path (``--sink=rtp+h264:// --encoder=tpu``)
would otherwise round-trip every enhanced frame through the host: D2H
of the enhanced NV12 out of the enhancement program, then H2D of the
same bytes back into the level program — ~25 MB/frame of PCIe traffic
at 4K, plus an extra dispatch.  Fusing the two into ONE jitted program
keeps frames in device memory as *pixels* end-to-end; the only thing that ever
comes down is the quantized levels the host entropy coder needs.

This mirrors the reference's datapath, where the VCU hardware encoder
consumes the enhanced frames on the device side of the appsrc boundary
and only the compressed bitstream crosses back
(``/root/reference/OpenCVequalHist.cpp:308-332``).

Design notes:

- the per-config enhancement graph is the SAME traceable closure the
  plain relay compiles (``models.enhancer.make_enhance_y``), so the
  fused stream is byte-identical to enhance-then-encode at equal qp
  (asserted in tests/test_fused_encode.py);
- level computation needs 16-aligned planes; padding replicates the
  host oracle (``io.h264_cavlc.CavlcH264Encoder._pad``: edge-replicate
  Y and the deinterleaved chroma) on device;
- the batch axis costs nothing extra: one slice per MB row makes MB
  rows independent, so N frames simply stack on the MB-row axis and a
  single ``encode_levels`` scan covers the whole batch;
- the output is the packed int16 level tensor (+ in-band qp,
  ``ops.h264_levels.pack_levels``) shaped (N, mb_h, mb_w, 409) — a
  plain array the FrameFeeder retires like a frame batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.models.enhancer import EnhancerConfig, make_enhance_y
from opencv_opencl_tpu.ops.h264_levels import (
    LevelArrays, encode_levels, encode_p_levels, pack_levels)

__all__ = ["build_enhance_levels_fn", "build_enhance_gop_fn",
           "GOP_PACKED_LANES", "GOP_PACKED_LANES_MV",
           "GOP_PACKED_LANES_MREF", "GOP_PACKED_LANES_PARTS",
           "GOP_PACKED_LANES_PARTS_MREF"]

# GOP packing = the intra packing (408 levels + qp) + a mode lane:
# per-MB 0/1/2 (P_Skip / P_L0_16x16 / I_16x16) on P frames, -1 on IDR
# frames (the frame-type marker the host entropy stage dispatches on).
# With motion search, two more lanes carry the per-MB (dy, dx) MV
# field (412 total); two references add the per-MB ref lane (413).
# The host side dispatches on the lane count.
GOP_PACKED_LANES = 410
GOP_PACKED_LANES_MV = 412
GOP_PACKED_LANES_MREF = 413
# partition configuration: 8 quadrant-MV lanes + the pmode lane
# (+ 4 per-quadrant reference lanes at two references)
GOP_PACKED_LANES_PARTS = 419
GOP_PACKED_LANES_PARTS_MREF = 423


def build_enhance_levels_fn(cfg: EnhancerConfig, spec: FrameSpec,
                            bitpack: int = 0, jit: bool = True):
    """Returns a jitted ``fn(nv12_batch: uint8[N, H*3/2, W], qp: int32)
    -> int16[N, mb_h, mb_w, 410]`` computing enhancement + quantized
    CAVLC levels (+ the per-MB intra pred-mode lane) in one XLA
    program (qp is traced: one compile serves the whole rate-control
    range).  ``bitpack=nw`` appends each MB's device-packed CAVLC
    bitstring as 1 + 2*nw extra lanes (ops/h264_bitpack.py; rows
    stacked across the batch stay independent slices, so the nC grids
    are computed on the stacked layout directly).  ``jit=False``
    returns the raw traceable closure (parallel/sharded_encode wraps
    it in shard_map, which must jit the OUTER step)."""
    if cfg.use_ref_frame:
        raise ValueError(
            "fused encode does not support the ref-frame streaming "
            "modes (their histogram state lives outside the batch fn)")
    h, w = spec.height, spec.width
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    mbh, mbw = h16 // 16, w16 // 16
    enhance_y, _ = make_enhance_y(cfg, spec)

    def fn(nv12_batch, qp):
        n = nv12_batch.shape[0]
        y = enhance_y(nv12_batch[:, :h, :])
        uv = nv12_batch[:, h:, :]
        if cfg.chroma == ChromaPolicy.GRAY:
            uv = jnp.full_like(uv, 128)
        # oracle-identical padding: edge-replicate Y and the
        # deinterleaved chroma planes (h264_cavlc._pad)
        cbcr = uv.reshape(n, h // 2, w // 2, 2)
        if h16 != h or w16 != w:
            y = jnp.pad(y, ((0, 0), (0, h16 - h), (0, w16 - w)),
                        mode="edge")
            cbcr = jnp.pad(
                cbcr, ((0, 0), (0, (h16 - h) // 2), (0, (w16 - w) // 2),
                       (0, 0)), mode="edge")
        # frames stack on the MB-row axis: rows are independent slices,
        # so one scan over MB columns covers the whole batch
        lv, imode = encode_levels(
            y.reshape(n * h16, w16),
            cbcr[..., 0].reshape(n * (h16 // 2), w16 // 2),
            cbcr[..., 1].reshape(n * (h16 // 2), w16 // 2),
            qp)
        packed = jnp.concatenate(
            [pack_levels(lv, qp), imode[:, :, None]],
            axis=-1)                          # (n*mbh, mbw, 410)
        if bitpack:
            from opencv_opencl_tpu.ops.h264_bitpack import pack_i_mbs

            packed = jnp.concatenate(
                [packed, _bits_lanes(*pack_i_mbs(
                    lv.zdc, lv.acz, lv.czdc, lv.cacz, imode,
                    nw_mb=int(bitpack)))], axis=-1)
        return packed.reshape(n, mbh, mbw, -1)

    return jax.jit(fn) if jit else fn


def _bits_lanes(words, nbits):
    """Fold device-packed CAVLC bitstrings into int16 feeder lanes:
    one nbits lane + 2*nw bitcast word lanes (LE halves; the host
    inverse is a contiguous uint32 view — io.h264_inter
    _split_bits_lanes)."""
    mbh, mbw, nw = words.shape
    wl = jax.lax.bitcast_convert_type(
        words, jnp.int16).reshape(mbh, mbw, 2 * nw)
    return jnp.concatenate(
        [nbits.astype(jnp.int16)[:, :, None], wl], axis=-1)


def build_enhance_gop_fn(cfg: EnhancerConfig, spec: FrameSpec, gop: int,
                         search: int = 0, subpel: int = 0,
                         refs: int = 1, deblock: bool = False,
                         gdr: int = 0, bitpack: int = 0,
                         parts: bool = False, jit: bool = True):
    """Fused enhance + low-delay-P GOP encode: returns a jitted
    ``fn(nv12_batch: uint8[N, H*3/2, W], qp: int32, idx0: int32,
    *recon) -> (int16[N, mb_h, mb_w, L], *recon')`` — recon is 3
    planes (ry, rcb, rcr), or 6 with ``refs=2`` (both reference
    pictures persist ACROSS batches in device memory; the frame right after
    each IDR runs a single-reference branch).  L = 412 lanes when
    ``search`` > 0 (two per-MB MV lanes from the device motion search
    ride down with the levels), 413 with refs=2 (the per-MB reference
    lane).

    The whole video encoder front half runs as ONE device program per
    batch: enhancement, then per frame either the intra level+recon
    scan (at GOP starts: ``(idx0 + i) % gop == 0``) or the P program
    (per-MB skip/inter/intra decisions) under ``lax.cond``, chained by
    a ``lax.scan`` over the batch because each P frame predicts from
    the previous frame's reconstruction — which therefore NEVER leaves
    device memory (the old recon buffers are donated).  The host receives only
    packed levels (+ in-band qp and mode lanes) and entropy-codes.

    Stream-order caveat: the recon/idx chain advances once per frame
    fed through this function, so the caller must NOT pad batches with
    repeated frames (relay --fused-encode sets pad_batches=False for
    GOP encoders).
    """
    if cfg.use_ref_frame:
        raise ValueError(
            "fused encode does not support the ref-frame streaming "
            "modes (their histogram state lives outside the batch fn)")
    if gop < 2:
        raise ValueError("fused GOP needs gop >= 2 (gop=1 is the "
                         "all-IDR fused path: build_enhance_levels_fn)")
    if refs not in (1, 2):
        raise ValueError(f"fused GOP refs must be 1 or 2, got {refs}")
    if refs > 1 and not search:
        raise ValueError("fused refs=2 requires search=R > 0")
    if gdr and refs > 1:
        raise ValueError("fused gdr requires refs=1")
    if parts:
        # same composition limits as TpuGopEncoder(parts=True)
        if not search:
            raise ValueError("fused parts requires search=R > 0")
        if subpel == 3:
            raise ValueError("parts does not compose with fastsub")
        if gdr:
            raise ValueError("fused parts requires no gdr")
        if refs > 1 and subpel == 2 and (
                refs * (8 * search + 1) ** 2 > 8192):
            raise ValueError(
                "quarter-pel parts with refs=2 needs search <= 7, "
                f"got {search}")
    h, w = spec.height, spec.width
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    mbh, mbw = h16 // 16, w16 // 16
    # GDR horizontal intra refresh inside the device scan: the wave
    # band rides into encode_p_levels as two traced scalars derived
    # from the frame index (same formula as TpuGopEncoder._dispatch;
    # the caller keeps gop at the one-IDR-ever sentinel)
    gdr_period = min(int(gdr), mbh) if gdr else 0
    gdr_rows = -(-mbh // gdr_period) if gdr else 0
    # device CAVLC bit-packing inside the scan (ops/h264_bitpack.py):
    # each frame's MB bitstrings ride down as extra int16 lanes
    # (1 nbits lane + 2*nw bitcast word lanes) next to the levels,
    # which stay in the tensor as the overflow/entropy fallback
    nw_mb = int(bitpack)
    if nw_mb:
        from opencv_opencl_tpu.ops.h264_bitpack import (pack_i_mbs,
                                                        pack_p_mbs)
    enhance_y, _ = make_enhance_y(cfg, spec)
    if deblock:
        # in-loop filter inside the device recon chain (idc=0, same
        # contract as TpuGopEncoder._dispatch: the reference picture
        # is the FILTERED reconstruction and never leaves device memory)
        from opencv_opencl_tpu.ops.h264_deblock import deblock_planes

        _dbi_idr = (jnp.ones((mbh, mbw), jnp.bool_),
                    jnp.zeros((mbh * 4, mbw * 4), jnp.bool_),
                    jnp.zeros((mbh, mbw, 2), jnp.int32),
                    jnp.zeros((mbh, mbw), jnp.int32))

        def _deblock_p(plv, qp):
            nnz4 = jnp.any(plv.acz != 0, axis=-1).reshape(
                mbh, mbw, 4, 4).transpose(0, 2, 1, 3).reshape(
                mbh * 4, mbw * 4)
            if parts:
                # quadrant-granular bS fields (per-8x8 motion)
                mvd = (plv.mv.astype(jnp.int32)
                       .reshape(mbh, mbw, 2, 2, 2)
                       .transpose(0, 2, 1, 3, 4)
                       .reshape(mbh * 2, mbw * 2, 2))
                refd = (jnp.zeros((mbh * 2, mbw * 2), jnp.int32)
                        if plv.ref is None
                        else plv.ref.astype(jnp.int32)
                        .reshape(mbh, mbw, 2, 2)
                        .transpose(0, 2, 1, 3)
                        .reshape(mbh * 2, mbw * 2))
            else:
                mvd = (jnp.zeros((mbh, mbw, 2), jnp.int32)
                       if plv.mv is None
                       else plv.mv.astype(jnp.int32))
                refd = (jnp.zeros((mbh, mbw), jnp.int32)
                        if plv.ref is None
                        else plv.ref.astype(jnp.int32))
            # GDR P slices are idc=2 (slice-local: no filtered sample
            # crosses the refresh wave)
            return deblock_planes(plv.recon_y, plv.recon_cb,
                                  plv.recon_cr, qp, plv.mode >= 2,
                                  nnz4, mvd, refd,
                                  slice_local=bool(gdr))

    def pack_gop(lv: LevelArrays, qp, mode, mv=None, ref=None,
                 pmode=None):
        base = pack_levels(lv, qp)                  # (mbh, mbw, 409)
        lanes = [base, mode.astype(jnp.int16)[:, :, None]]
        if parts:
            # 8 quadrant-MV lanes + the partition-mode lane (IDR
            # frames pack zeros; the mode lane marks them); with
            # refs > 1, 4 per-quadrant reference lanes follow
            lanes.append(jnp.zeros((mbh, mbw, 8), jnp.int16)
                         if mv is None
                         else mv.astype(jnp.int16).reshape(mbh, mbw, 8))
            lanes.append(jnp.zeros((mbh, mbw, 1), jnp.int16)
                         if pmode is None
                         else pmode.astype(jnp.int16)[:, :, None])
            if refs > 1:
                lanes.append(jnp.zeros((mbh, mbw, 4), jnp.int16)
                             if ref is None
                             else ref.astype(jnp.int16))
            return jnp.concatenate(lanes, axis=-1)
        if search:
            lanes.append(jnp.zeros((mbh, mbw, 2), jnp.int16)
                         if mv is None else mv.astype(jnp.int16))
        if refs > 1:
            lanes.append(jnp.zeros((mbh, mbw, 1), jnp.int16)
                         if ref is None
                         else ref.astype(jnp.int16)[:, :, None])
        return jnp.concatenate(lanes, axis=-1)

    def fn(nv12_batch, qp, idx0, ry, rcb, rcr,
           oy=None, ocb=None, ocr=None):
        n = nv12_batch.shape[0]
        y = enhance_y(nv12_batch[:, :h, :])
        uv = nv12_batch[:, h:, :]
        if cfg.chroma == ChromaPolicy.GRAY:
            uv = jnp.full_like(uv, 128)
        cbcr = uv.reshape(n, h // 2, w // 2, 2)
        if h16 != h or w16 != w:
            y = jnp.pad(y, ((0, 0), (0, h16 - h), (0, w16 - w)),
                        mode="edge")
            cbcr = jnp.pad(
                cbcr, ((0, 0), (0, (h16 - h) // 2), (0, (w16 - w) // 2),
                       (0, 0)), mode="edge")

        def per_frame(carry, xs):
            # refs=1 carries one recon set; refs=2 carries both (the
            # dead-state cost of a uniform 6-plane carry is real:
            # ~1.5 frames of copies per scan step)
            if refs > 1:
                ry, rcb, rcr, oy, ocb, ocr, idx = carry
            else:
                ry, rcb, rcr, idx = carry
                oy = ocb = ocr = None
            yf, cbf, crf = xs

            def do_i(args):
                yf, cbf, crf, ry, rcb, rcr, *old = args
                lv, ry2, rcb2, rcr2, imode = encode_levels(
                    yf, cbf, crf, qp, full_recon=True)
                if deblock:
                    ry2, rcb2, rcr2 = deblock_planes(
                        ry2, rcb2, rcr2, qp, *_dbi_idr)
                # IDR marker doubles as the intra pred mode:
                # -1 = I_16x16 DC, -2 = I_16x16 HORIZONTAL
                mode = jnp.where(imode == 1, -2, -1).astype(jnp.int16)
                out = pack_gop(lv, qp, mode)
                if nw_mb:
                    out = jnp.concatenate(
                        [out, _bits_lanes(*pack_i_mbs(
                            lv.zdc, lv.acz, lv.czdc, lv.cacz, imode,
                            nw_mb=nw_mb))], axis=-1)
                # IDR flushes the DPB: the second slot is a dummy
                # (the next frame's single-reference branch never
                # reads it)
                extra = (ry2, rcb2, rcr2) if refs > 1 else ()
                return (out, ry2, rcb2, rcr2) + extra

            def do_p1(args):
                yf, cbf, crf, ry, rcb, rcr, *old = args
                band = None
                if gdr:
                    m = (idx - 1) % gdr_period
                    band = (m.astype(jnp.int32) * gdr_rows,
                            jnp.minimum((m + 1) * gdr_rows, mbh)
                            .astype(jnp.int32))
                plv = encode_p_levels(yf, cbf, crf, ry, rcb, rcr, qp,
                                      search, subpel, gdr_band=band,
                                      parts=1 if parts else 0)
                lv = LevelArrays(plv.zdc, plv.acz, plv.czdc, plv.cacz)
                rec = ((plv.recon_y, plv.recon_cb, plv.recon_cr)
                       if not deblock else _deblock_p(plv, qp))
                out = pack_gop(lv, qp, plv.mode, plv.mv,
                               pmode=plv.pmode)
                if nw_mb:
                    pk = (dict(pmode=plv.pmode, mv4=plv.mv,
                               ref4=plv.ref) if parts
                          else dict())
                    out = jnp.concatenate(
                        [out, _bits_lanes(*pack_p_mbs(
                            plv.mode, plv.zdc, plv.acz, plv.czdc,
                            plv.cacz,
                            None if parts else plv.mv, None,
                            jnp.int32(1), nw_mb=nw_mb, **pk))],
                        axis=-1)
                extra = (ry, rcb, rcr) if refs > 1 else ()
                return (out, *rec) + extra

            def do_p2(args):
                yf, cbf, crf, ry, rcb, rcr, oy, ocb, ocr = args
                plv = encode_p_levels(yf, cbf, crf, ry, rcb, rcr, qp,
                                      search, subpel, oy, ocb, ocr,
                                      parts=1 if parts else 0)
                lv = LevelArrays(plv.zdc, plv.acz, plv.czdc, plv.cacz)
                rec = ((plv.recon_y, plv.recon_cb, plv.recon_cr)
                       if not deblock else _deblock_p(plv, qp))
                out = pack_gop(lv, qp, plv.mode, plv.mv, plv.ref,
                               pmode=plv.pmode)
                if nw_mb:
                    pk = (dict(pmode=plv.pmode, mv4=plv.mv,
                               ref4=plv.ref) if parts
                          else dict())
                    out = jnp.concatenate(
                        [out, _bits_lanes(*pack_p_mbs(
                            plv.mode, plv.zdc, plv.acz, plv.czdc,
                            plv.cacz,
                            None if parts else plv.mv,
                            None if parts else plv.ref,
                            jnp.int32(2), nw_mb=nw_mb, **pk))],
                        axis=-1)
                return (out, *rec, ry, rcb, rcr)

            if refs > 1:
                args = (yf, cbf, crf, ry, rcb, rcr, oy, ocb, ocr)
                branch = jnp.where(
                    idx % gop == 0, 0,
                    jnp.where(idx % gop == 1, 1, 2))
                packed, *recs = jax.lax.switch(
                    branch, (do_i, do_p1, do_p2), args)
            else:
                args = (yf, cbf, crf, ry, rcb, rcr)
                packed, *recs = jax.lax.cond(
                    idx % gop == 0, do_i, do_p1, args)
            return tuple(recs) + (idx + 1,), packed

        if refs > 1:
            init = (ry, rcb, rcr, oy, ocb, ocr,
                    jnp.asarray(idx0, jnp.int32))
        else:
            init = (ry, rcb, rcr, jnp.asarray(idx0, jnp.int32))
        (*recs, _), packed = jax.lax.scan(
            per_frame, init, (y, cbcr[..., 0], cbcr[..., 1]))
        return (packed, *recs)

    if not jit:
        # raw traceable closure for parallel/sharded_encode: the GOP-
        # per-device step creates its recon zeros inside shard_map, so
        # donation does not apply (XLA dead-code-eliminates the final
        # recon outputs instead)
        return fn
    if refs > 1:
        return jax.jit(fn, donate_argnums=(3, 4, 5, 6, 7, 8))
    return jax.jit(fn, donate_argnums=(3, 4, 5))
