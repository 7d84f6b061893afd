"""Sub-16x16 inter partitions (16x8 / 8x16 / 8x8 with per-partition
mvd): the VCU's low-delay-P partition coding
(/root/reference/OpenCVequalHist.cpp:313-315) rebuilt on the shared
oracle/device contract:

- the oracle stream must be libavcodec-conformant with BIT-IDENTICAL
  reconstruction (proves mb_type/sub_mb_type/mvd and the one-row-slice
  8.4.1.3 predictor collapse against a real decoder);
- the device program (ops/h264_levels.encode_p_levels parts=1) must be
  byte-identical to the oracle;
- partitions must MEASURABLY beat P_16x16 on shear/rotation content
  (the round-4 verdict's acceptance bar).
"""

from __future__ import annotations

import numpy as np
import pytest

from opencv_opencl_tpu.io.h264_inter import (
    GopCavlcEncoder, TpuGopEncoder, motion_search_parts)

W, H, QP, N = 128, 96, 30, 6
MB_H = H // 16


def shear_frames(n=N, w=W, h=H, split=40, step=3):
    """Top band pans +step px/frame, bottom band -step, with the split
    INSIDE an MB row so straddling MBs want 16x8 partitions."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h, w), np.uint8)
    base = (base.reshape(h // 4, 4, w // 4, 4).mean((1, 3))
            .astype(np.uint8).repeat(4, 0).repeat(4, 1))
    uvb = rng.integers(96, 160, (h // 2, w), np.uint8)
    frames = []
    for i in range(n):
        y = base.copy()
        y[:split] = np.roll(base[:split], step * i, 1)
        y[split:] = np.roll(base[split:], -step * i, 1)
        uv = uvb.copy()
        uv[:split // 2] = np.roll(uvb[:split // 2], 2 * i, 1)
        uv[split // 2:] = np.roll(uvb[split // 2:], -2 * i, 1)
        frames.append(np.concatenate([y, uv], 0))
    return frames


def rotation_frames(n=N, w=W, h=H, deg=1.5):
    """Slow rotation: the motion field varies continuously across the
    frame — the content class where one MV per MB collapses toward
    intra cost but per-quadrant MVs keep cheap P MBs."""
    import cv2

    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (h, w), np.uint8)
    base = (base.reshape(h // 8, 8, w // 8, 8).mean((1, 3))
            .astype(np.uint8).repeat(8, 0).repeat(8, 1))
    uvb = np.full((h // 2, w), 128, np.uint8)
    frames = []
    for i in range(n):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), deg * i, 1.0)
        y = cv2.warpAffine(base, m, (w, h),
                           flags=cv2.INTER_NEAREST,
                           borderMode=cv2.BORDER_REPLICATE)
        frames.append(np.concatenate([y, uvb], 0))
    return frames


def stream(enc, frames):
    return [au for f in frames for au in enc.encode(f)]


def decode_gray(es: bytes, tmp_path, n, w):
    import cv2

    p = tmp_path / "parts.h264"
    p.write_bytes(es)
    cap = cv2.VideoCapture(str(p))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    for i in range(n):
        ok, f = cap.read()
        assert ok, f"decoder produced only {i}/{n} frames"
        out.append(f.reshape(-1, w).copy())
    cap.release()
    return out


# ---------------------------------------------------------------- oracle

class TestOracle:
    @pytest.mark.parametrize("kw", [
        dict(search=4),
        dict(search=4, halfpel=True),
        dict(search=2, quarterpel=True),
    ], ids=["fullpel", "halfpel", "qpel"])
    def test_conformant_bitexact_recon(self, kw, tmp_path):
        frames = shear_frames()
        enc = GopCavlcEncoder(W, H, qp=QP, gop=N, slices=MB_H,
                              parts=True, **kw)
        aus, recons = [], []
        for f in frames:
            aus += enc.encode(f)
            recons.append(enc._recon)
        dec = decode_gray(b"".join(aus) + aus[0], tmp_path, N, W)
        for i in range(N):
            assert np.array_equal(dec[i][:H],
                                  recons[i][0].astype(np.uint8)), \
                f"libavcodec recon mismatch at frame {i}"

    def test_partition_decision_shapes(self):
        """The decision picks the partition matching the motion
        geometry: 16x8 on a horizontal shear line, 8x16 on a vertical
        one, and opposing MVs land in the right quadrants."""
        frames = shear_frames()
        y1, y0 = frames[2][:H].astype(np.int64), \
            frames[1][:H].astype(np.int64)
        pmode, mv4 = motion_search_parts(y1, y0, 4, qp=QP)
        row = 40 // 16                      # the straddling MB row
        assert (pmode[row] == 1).sum() >= MB_H, \
            f"expected 16x8 on the shear row, got {pmode[row]}"
        mb = mv4[row, 3]
        # top pans +x so its reference block sits at -x (and vice
        # versa for the bottom partition)
        assert mb[0][1] < 0 < mb[2][1]
        assert np.all(mb[0] == mb[1]) and np.all(mb[2] == mb[3])
        # transpose the content: vertical split -> 8x16
        pmode_t, mv4_t = motion_search_parts(
            np.ascontiguousarray(y1.T[:W // 16 * 16, :H // 16 * 16]),
            np.ascontiguousarray(y0.T[:W // 16 * 16, :H // 16 * 16]),
            4, qp=QP)
        col = 40 // 16
        assert (pmode_t[:, col] == 2).sum() >= 3, \
            f"expected 8x16 on the transposed shear col, " \
            f"got {pmode_t[:, col]}"

    def test_parts_beat_16x16_on_rotation(self):
        """The verdict's acceptance bar: a measured AU-size win where
        P_16x16 degrades toward intra cost."""
        frames = rotation_frames()
        plain = stream(GopCavlcEncoder(W, H, qp=QP, gop=N,
                                       slices=MB_H, search=4), frames)
        parts = stream(GopCavlcEncoder(W, H, qp=QP, gop=N,
                                       slices=MB_H, search=4,
                                       parts=True), frames)
        p_plain = sum(map(len, plain[1:]))
        p_parts = sum(map(len, parts[1:]))
        assert p_parts < p_plain, (p_parts, p_plain)

    def test_refusals(self):
        with pytest.raises(ValueError, match="parts requires search"):
            GopCavlcEncoder(W, H, gop=N, slices=MB_H, parts=True)
        with pytest.raises(ValueError, match="fastsub"):
            GopCavlcEncoder(W, H, gop=N, slices=MB_H, search=4,
                            fastsub=True, parts=True)
        with pytest.raises(ValueError, match="search <= 7"):
            # refs=2 x quarter-pel parts: key-packing bound
            GopCavlcEncoder(W, H, gop=N, slices=MB_H, search=8,
                            refs=2, quarterpel=True, parts=True)
        with pytest.raises(ValueError, match="one slice per MB row"):
            GopCavlcEncoder(W, H, gop=N, slices=1, search=4,
                            parts=True)
        with pytest.raises(ValueError, match="no gdr"):
            GopCavlcEncoder(W, H, slices=MB_H, search=4, gdr=2,
                            parts=True)


# ------------------------------------------------------------- device twin

class TestTpuParity:
    @pytest.mark.parametrize("kw", [
        dict(search=4),
        dict(search=4, halfpel=True),
        dict(search=2, quarterpel=True),
    ], ids=["fullpel", "halfpel", "qpel"])
    def test_byte_identity_shear(self, kw):
        frames = shear_frames()
        got = stream(TpuGopEncoder(W, H, qp=QP, gop=N, parts=True,
                                   **kw), frames)
        want = stream(GopCavlcEncoder(W, H, qp=QP, gop=N,
                                      slices=MB_H, parts=True, **kw),
                      frames)
        assert got == want

    def test_byte_identity_rotation_overlap(self):
        frames = rotation_frames()
        got = stream(TpuGopEncoder(W, H, qp=QP, gop=N, search=4,
                                   parts=True, overlap=True), frames)
        got += TpuGopEncoder(W, H, qp=QP, gop=N, search=4,
                             parts=True).flush()  # overlap flushes []
        want = stream(GopCavlcEncoder(W, H, qp=QP, gop=N,
                                      slices=MB_H, search=4,
                                      parts=True), frames)
        # overlap delays by one frame; drain it
        enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=4, parts=True,
                            overlap=True)
        got = [au for f in frames for au in enc.encode(f)]
        got += enc.flush()
        assert got == want

    def test_byte_identity_nonaligned_geometry(self):
        w, h = 104, 56                       # pads to 112x64
        frames = shear_frames(w=w, h=h, split=24, step=2)
        got = stream(TpuGopEncoder(w, h, qp=QP, gop=N, search=2,
                                   parts=True), frames)
        want = stream(GopCavlcEncoder(w, h, qp=QP, gop=N,
                                      slices=-(-h // 16), search=2,
                                      parts=True), frames)
        assert got == want

    @pytest.mark.parametrize("seed", [1, 2])
    def test_byte_identity_fuzz(self, seed):
        """Random content at a high qp mixes skip / intra / every
        partition mode through both paths."""
        rng = np.random.default_rng(seed)
        qp = int(rng.integers(24, 44))
        frames = []
        base = rng.integers(0, 256, (H, W), np.uint8)
        for i in range(4):
            y = np.roll(base, int(rng.integers(-3, 4)), 1)
            y[40:56, 16:64] = rng.integers(0, 256, (16, 48), np.uint8)
            uv = rng.integers(0, 256, (H // 2, W), np.uint8)
            frames.append(np.concatenate([y, uv], 0))
        got = stream(TpuGopEncoder(W, H, qp=qp, gop=4, search=2,
                                   parts=True), frames)
        want = stream(GopCavlcEncoder(W, H, qp=qp, gop=4,
                                      slices=MB_H, search=2,
                                      parts=True), frames)
        assert got == want

    def test_conformance_of_tpu_stream(self, tmp_path):
        import cv2

        frames = rotation_frames()
        aus = stream(TpuGopEncoder(W, H, qp=QP, gop=N, search=4,
                                   parts=True), frames)
        p = tmp_path / "tpu_parts.h264"
        p.write_bytes(b"".join(aus) + aus[0])
        cap = cv2.VideoCapture(str(p))
        n = 0
        while True:
            ok, _ = cap.read()
            if not ok:
                break
            n += 1
        cap.release()
        assert n >= N


# ------------------------------------------------------------- plumbing

class TestSpec:
    def test_encoder_spec_parses(self):
        from opencv_opencl_tpu.io.encoder import make_encoder

        enc = make_encoder("tpu:qp=30:gop=4:search=2:parts", W, H)
        assert isinstance(enc, TpuGopEncoder) and enc.parts
        enc2 = make_encoder("cavlc:qp=30:gop=4:search=2:parts", W, H)
        assert isinstance(enc2, GopCavlcEncoder) and enc2.parts

    def test_spec_refusals(self):
        from opencv_opencl_tpu.io.encoder import make_encoder

        with pytest.raises(ValueError, match="gop"):
            make_encoder("tpu:qp=30:parts", W, H)


class TestFused:
    def test_fused_parts_matches_unfused(self):
        """The fused enhance+GOP program with parts (419 lanes: 8
        quadrant-MV lanes + pmode) streams byte-identical to the
        unfused device chain on the same enhanced frames."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu.models.enhancer import (
            EnhancerConfig, build_enhance_fn)
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        frames = np.stack(shear_frames())
        spec = FrameSpec(width=W, height=H, fps=30)
        cfg = EnhancerConfig(op="clahe", clip_limit=2.0,
                             tile_grid=(8, 8),
                             chroma=ChromaPolicy.PASSTHROUGH)
        plain = build_enhance_fn(cfg, spec, donate=False)
        enh = np.asarray(plain(frames))
        ref_enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=4,
                                parts=True)
        want = [au for f in enh for au in ref_enc.encode(f)]

        enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=4, parts=True)
        fn = build_enhance_gop_fn(cfg, spec, enc.gop, search=4,
                                  parts=True)
        recon = list(enc.initial_recon())
        got, idx = [], 0
        for lo, hi in ((0, 3), (3, N)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(QP), idx,
                                *recon)
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(
                    np.asarray(packed)[i]))
        assert got == want

    def test_fused_parts_refusals(self):
        from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu.models.enhancer import EnhancerConfig
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        spec = FrameSpec(width=W, height=H, fps=30)
        cfg = EnhancerConfig(op="clahe", clip_limit=2.0,
                             tile_grid=(8, 8),
                             chroma=ChromaPolicy.PASSTHROUGH)
        with pytest.raises(ValueError, match="parts requires search"):
            build_enhance_gop_fn(cfg, spec, 4, parts=True)
        with pytest.raises(ValueError, match="no gdr"):
            build_enhance_gop_fn(cfg, spec, 4, search=2, parts=True,
                                 gdr=2)


# ------------------------------------------------------- parts x refs=2

def flicker_shear_frames():
    """Shear + alternating-brightness flicker: the 2-back reference
    matches even frames, 1-back matches odd — mixed per-partition
    refs AND partition modes (the refs x parts composition's stress
    content)."""
    rng = np.random.default_rng(5)
    base = (rng.integers(0, 256, (H // 8 + 4, W // 8 + 4), np.uint8)
            .repeat(8, 0).repeat(8, 1))
    frames = []
    for i in range(N):
        y = np.empty((H, W), np.uint8)
        for r in range(H):
            y[r] = np.roll(base[r + 8, 8:8 + W], (r * i) // H + 2 * i)
        if i % 2 == 0:
            y = np.clip(y.astype(np.int32) + 20, 0,
                        255).astype(np.uint8)
        uv = np.full((H // 2, W), 128, np.uint8)
        frames.append(np.concatenate([y, uv]).copy())
    return frames


class TestPartsRefs2:
    @pytest.mark.parametrize("kw", [
        dict(search=3),
        dict(search=3, halfpel=True),
        dict(search=2, quarterpel=True),
    ], ids=["fullpel", "halfpel", "qpel"])
    def test_conformant_bitexact_recon(self, kw, tmp_path):
        frames = flicker_shear_frames()
        enc = GopCavlcEncoder(W, H, qp=QP, gop=N, slices=MB_H,
                              refs=2, parts=True, **kw)
        aus, recons = [], []
        for f in frames:
            aus += enc.encode(f)
            recons.append(enc._recon)
        dec = decode_gray(b"".join(aus) + aus[0], tmp_path, N, W)
        for i in range(N):
            assert np.array_equal(dec[i][:H],
                                  recons[i][0].astype(np.uint8)), \
                f"libavcodec recon mismatch at frame {i}"

    def test_mixed_refs_and_partitions_exercised(self):
        from opencv_opencl_tpu.io.h264_inter import (
            motion_search_parts_multi)

        frames = flicker_shear_frames()
        cur = frames[4][:H].astype(np.int64)
        pl = [np.pad(frames[i][:H].astype(np.int64), 3,
                     mode="edge").astype(np.uint8)[None]
              for i in (3, 2)]
        pmode, mv4, ref4 = motion_search_parts_multi(
            cur, pl, 3, 0, 3, qp=QP)
        assert (ref4 == 1).any() and (ref4 == 0).any()
        assert (pmode > 0).any()
        mixed = (ref4.max(axis=2) != ref4.min(axis=2)).sum()
        assert mixed > 0, "no MB with mixed per-partition refs"

    def test_tpu_stream_byte_identity(self):
        from opencv_opencl_tpu.io.encoder import make_encoder

        frames = flicker_shear_frames()

        def run(spec):
            enc = make_encoder(spec, W, H, 30)
            return b"".join(b"".join(enc.encode(f)) for f in frames)

        tail = f"qp={QP}:gop={N}:search=3:refs=2:parts"
        assert (run("tpu:" + tail)
                == run(f"cavlc:{tail}:slices={MB_H}"))


class TestNativePartsRows:
    """The C++ entropy rows (fp_cavlc_entropy_rows_p pmode/mv4/ref4
    path) must be byte-identical to the Python from-levels writer."""

    @pytest.mark.parametrize("refs", [1, 2])
    def test_native_matches_python(self, refs):
        from opencv_opencl_tpu import native

        if not native.available():
            pytest.skip(f"native lib unavailable: {native.build_error()}")
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import (
            encode_frame_p_from_levels)
        from opencv_opencl_tpu.ops import h264_levels as hl

        frames = flicker_shear_frames()
        y2 = frames[4][:H]
        r1 = frames[3][:H]
        r2 = frames[2][:H]
        c = np.full((H // 2, W // 2), 128, np.uint8)
        kw = {}
        if refs == 2:
            kw = dict(ry2=jnp.asarray(r2), rcb2=jnp.asarray(c),
                      rcr2=jnp.asarray(c))
        out = hl.encode_p_levels(
            jnp.asarray(y2), jnp.asarray(c), jnp.asarray(c),
            jnp.asarray(r1), jnp.asarray(c), jnp.asarray(c),
            jnp.int32(QP), search=3, subpel=0, parts=1, **kw)
        mode, zdc, acz, czdc, cacz = (np.asarray(a) for a in out[:5])
        mv4 = np.asarray(out.mv)
        pm = np.asarray(out.pmode)
        r4 = None if out.ref is None else np.asarray(out.ref)
        py = encode_frame_p_from_levels(
            mode, zdc, acz, czdc, cacz, QP, 1, mv=mv4, ref=r4,
            active_refs=refs, pmode=pm)
        nat = native.cavlc_entropy_rows_p(
            mode, zdc, acz, czdc, cacz, QP, 1, active_refs=refs,
            pmode=pm, mv4=mv4, ref4=r4)
        assert [bytes(a) for a in py] == [bytes(b) for b in nat]


class TestFusedPartsRefs2:
    """fused x parts x refs=2 (423 lanes: +4 per-quadrant reference
    lanes) and fused x parts x deblock — both byte-identical to the
    unfused device chain."""

    def _run(self, **kw):
        import jax.numpy as jnp

        from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu.models.enhancer import EnhancerConfig
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        frames = np.stack(flicker_shear_frames())
        spec = FrameSpec(width=W, height=H, fps=30)
        cfg = EnhancerConfig(op="none",
                             chroma=ChromaPolicy.PASSTHROUGH)
        ref_enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=3,
                                parts=True, **kw)
        want = [au for f in frames for au in ref_enc.encode(f)]
        fn = build_enhance_gop_fn(cfg, spec, N, search=3, parts=True,
                                  **kw)
        enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=3, parts=True,
                            **kw)
        recon = list(enc.initial_recon())
        got, idx, last = [], 0, None
        for lo, hi in ((0, 3), (3, N)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(QP), idx,
                                *recon)
            idx += hi - lo
            last = np.asarray(packed)
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(last[i]))
        assert got == want
        return last

    def test_fused_parts_refs2(self):
        packed = self._run(refs=2)
        assert packed.shape[-1] == 423
        assert packed[:, :, :, 419:423].any(), "ref 1 never chosen"

    def test_fused_parts_deblock(self):
        packed = self._run(deblock=True)
        assert packed.shape[-1] == 419


class TestPartsBitpack:
    """Device CAVLC bit-packing for partitioned frames: the parts
    header (mb_type/sub_mb_type, per-partition te(v) ref_idx, mvd
    against the vectorized reference-aware predictor) packed ON
    DEVICE, byte-identical streams."""

    @pytest.mark.parametrize("refs", [1, 2])
    def test_bitpack_stream_matches_oracle(self, refs):
        frames = flicker_shear_frames()
        want = stream(GopCavlcEncoder(W, H, qp=QP, gop=N, slices=MB_H,
                                      search=3, parts=True, refs=refs),
                      frames)
        got = stream(TpuGopEncoder(W, H, qp=QP, gop=N, search=3,
                                   parts=True, refs=refs,
                                   bitpack=True, nw_mb=64), frames)
        assert got == want

    def test_fused_bitpack_matches(self):
        """fused x parts x bitpack: the packed-bits lanes ride next to
        the 419-lane level layout and assemble byte-identically."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu.models.enhancer import EnhancerConfig
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        frames = np.stack(flicker_shear_frames())
        spec = FrameSpec(width=W, height=H, fps=30)
        cfg = EnhancerConfig(op="none",
                             chroma=ChromaPolicy.PASSTHROUGH)
        ref_enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=3,
                                parts=True)
        want = [au for f in frames for au in ref_enc.encode(f)]
        fn = build_enhance_gop_fn(cfg, spec, N, search=3, parts=True,
                                  bitpack=64)
        enc = TpuGopEncoder(W, H, qp=QP, gop=N, search=3, parts=True,
                            bitpack=True, nw_mb=64)
        recon = list(enc.initial_recon())
        got, idx = [], 0
        for lo, hi in ((0, 3), (3, N)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(QP), idx,
                                *recon)
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(
                    np.asarray(packed)[i]))
        assert got == want
