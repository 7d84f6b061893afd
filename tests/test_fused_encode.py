"""Fused enhance + H.264 encode device program (models/fused_encode.py).

Contract: the fused program's stream is BYTE-IDENTICAL to running the
plain enhancement program and the device CAVLC encoder separately at the
same qp — for every enhancement op, chroma policy, and non-16-aligned
geometry.  (Reference analogue: the VCU consumes enhanced frames on the
device side of appsrc, ``OpenCVequalHist.cpp:308-332``.)
"""

from __future__ import annotations

import numpy as np
import pytest

from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.io.h264_cavlc import TpuCavlcEncoder
from opencv_opencl_tpu.models.enhancer import EnhancerConfig, build_enhance_fn
from opencv_opencl_tpu.models.fused_encode import build_enhance_levels_fn
from opencv_opencl_tpu.ops.h264_levels import (
    PACKED_LANES, encode_levels_nv12, pack_levels, unpack_levels_host)


def rand_nv12_batch(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h * 3 // 2, w), np.uint8)


def fused_aus(cfg, spec, frames, qp):
    import jax.numpy as jnp

    fn = build_enhance_levels_fn(cfg, spec)
    packed = np.asarray(fn(frames, jnp.int32(qp)))
    assert packed.dtype == np.int16
    # PACKED_LANES levels+qp plus the per-MB intra pred-mode lane
    assert packed.shape == (len(frames), -(-spec.height // 16),
                            -(-spec.width // 16), PACKED_LANES + 1)
    enc = TpuCavlcEncoder(spec.width, spec.height, qp=qp)
    return [au for i in range(len(frames))
            for au in enc.encode_from_packed(packed[i])]


def unfused_aus(cfg, spec, frames, qp):
    plain = build_enhance_fn(cfg, spec, donate=False)
    enh = np.asarray(plain(frames))
    enc = TpuCavlcEncoder(spec.width, spec.height, qp=qp)
    return [au for f in enh for au in enc.encode(f)]


class TestFusedVsUnfused:
    @pytest.mark.parametrize("w,h,op,chroma", [
        (96, 64, "clahe", ChromaPolicy.PASSTHROUGH),
        (100, 56, "histeq", ChromaPolicy.GRAY),   # 16-pad both axes
        (112, 72, "none", ChromaPolicy.PASSTHROUGH),
    ])
    def test_stream_byte_identical(self, w, h, op, chroma):
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op=op, chroma=chroma)
        frames = rand_nv12_batch(w, h, 3, seed=hash((w, op)) & 0xFFFF)
        qp = 28
        assert fused_aus(cfg, spec, frames, qp) == \
            unfused_aus(cfg, spec, frames, qp)

    def test_ref_frame_mode_refused(self):
        spec = FrameSpec(width=96, height=64, fps=30)
        cfg = EnhancerConfig(op="clahe", use_ref_frame=True)
        with pytest.raises(ValueError, match="ref-frame"):
            build_enhance_levels_fn(cfg, spec)


class TestPackedLayout:
    def test_pack_unpack_roundtrip(self):
        import jax.numpy as jnp

        w, h, qp = 96, 64, 33
        nv12 = rand_nv12_batch(w, h, 1, seed=3)[0]
        lv, _ = encode_levels_nv12(nv12, w, h, qp)
        packed = np.asarray(pack_levels(lv, jnp.int32(qp)))
        got, got_qp = unpack_levels_host(packed)
        assert got_qp == qp
        for a, b in zip(got, lv):
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_unpack_rejects_wrong_lanes(self):
        with pytest.raises(ValueError, match="lanes"):
            unpack_levels_host(np.zeros((2, 2, 17), np.int16))

    def test_inband_qp_wins_over_mutated_encoder_qp(self):
        """The slice header must carry the qp the levels were quantized
        with, even if rate control moved encoder.qp between dispatch
        and assembly (the pipelined-producer case)."""
        import jax.numpy as jnp

        w, h, qp = 96, 64, 30
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="none", chroma=ChromaPolicy.PASSTHROUGH)
        frames = rand_nv12_batch(w, h, 1, seed=9)
        fn = build_enhance_levels_fn(cfg, spec)
        packed = np.asarray(fn(frames, jnp.int32(qp)))
        enc = TpuCavlcEncoder(w, h, qp=qp)
        enc.qp = 44  # simulate a rate-control move while in flight
        got = enc.encode_from_packed(packed[0])
        ref = TpuCavlcEncoder(w, h, qp=qp)
        assert got == ref.encode(frames[0])


class TestFusedGop:
    def test_fused_gop_matches_unfused_tpu_gop(self):
        """The fused enhance+GOP program chain, fed in uneven batches,
        streams byte-identical to enhance-then-TpuGopEncoder."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            GOP_PACKED_LANES, build_enhance_gop_fn)

        w, h, qp, gop = 96, 64, 30, 3
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="clahe", chroma=ChromaPolicy.PASSTHROUGH)
        frames = rand_nv12_batch(w, h, 8, seed=21)
        # make consecutive frames similar so inter/skip modes appear
        for i in range(1, 8):
            frames[i] = frames[i - 1].copy()
            frames[i][5:25, 8 + 4 * i:40 + 4 * i] ^= 0x5A

        # unfused: enhancement program -> host -> device GOP encoder
        plain = build_enhance_fn(cfg, spec, donate=False)
        enh = np.asarray(plain(frames))
        ref_enc = TpuGopEncoder(w, h, qp=qp, gop=gop)
        want = [au for f in enh for au in ref_enc.encode(f)]

        # fused: batches of 3 + 3 + 2 through the stateful chain
        fn = build_enhance_gop_fn(cfg, spec, gop)
        enc = TpuGopEncoder(w, h, qp=qp, gop=gop)
        recon = enc.initial_recon()
        idx, got = 0, []
        for lo, hi in ((0, 3), (3, 6), (6, 8)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(qp), idx,
                                *recon)
            packed = np.asarray(packed)
            assert packed.shape[-1] == GOP_PACKED_LANES
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(packed[i]))
        assert got == want

    def test_fused_gop_deblock_matches_unfused(self):
        """deblock inside the fused device scan: the filtered-reference
        chain must stream byte-identical to tpu:gop=N:deblock (whose
        recon filter is decoder-conformance proven)."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        w, h, qp, gop = 96, 64, 30, 3
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="clahe",
                             chroma=ChromaPolicy.PASSTHROUGH)
        frames = rand_nv12_batch(w, h, 6, seed=33)
        for i in range(1, 6):
            frames[i] = frames[i - 1].copy()
            frames[i][5:25, 8 + 4 * i:40 + 4 * i] ^= 0x5A

        plain = build_enhance_fn(cfg, spec, donate=False)
        enh = np.asarray(plain(frames))
        ref_enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=2,
                                deblock=True)
        want = [au for f in enh for au in ref_enc.encode(f)]

        fn = build_enhance_gop_fn(cfg, spec, gop, search=2,
                                  deblock=True)
        enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=2,
                            deblock=True)
        recon = enc.initial_recon()
        idx, got = 0, []
        for lo, hi in ((0, 4), (4, 6)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(qp), idx,
                                *recon)
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(
                    np.asarray(packed)[i]))
        assert got == want

    @pytest.mark.parametrize("kw", [
        {}, {"search": 2, "quarterpel": True},
        {"deblock": True, "search": 2},
    ], ids=["zero-motion", "qpel", "deblock-search"])
    def test_fused_gdr_matches_unfused(self, kw):
        """GDR inside the fused device scan: the marching intra band
        (traced from the frame index), wave-start SPS+PPS+recovery SEI
        on the host side, restricted motion and slice-local (idc=2)
        deblocking must all stream byte-identical to tpu:gdr=N."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        w, h, qp, gdr = 96, 64, 30, 3
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="clahe",
                             chroma=ChromaPolicy.PASSTHROUGH)
        frames = rand_nv12_batch(w, h, 8, seed=44)
        for i in range(1, 8):
            frames[i] = frames[i - 1].copy()
            frames[i][5:25, 8 + 4 * i:40 + 4 * i] ^= 0x5A

        plain = build_enhance_fn(cfg, spec, donate=False)
        enh = np.asarray(plain(frames))
        ref_enc = TpuGopEncoder(w, h, qp=qp, gdr=gdr, **kw)
        want = [au for f in enh for au in ref_enc.encode(f)]

        enc = TpuGopEncoder(w, h, qp=qp, gdr=gdr, **kw)
        fn = build_enhance_gop_fn(cfg, spec, enc.gop,
                                  search=enc.search,
                                  subpel=enc.subpel,
                                  deblock=enc.deblock, gdr=gdr)
        recon = enc.initial_recon()
        idx, got = 0, []
        for lo, hi in ((0, 3), (3, 6), (6, 8)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(qp), idx,
                                *recon)
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(
                    np.asarray(packed)[i]))
        assert got == want
        # GDR stream shape survives the fused path: no IDR after
        # frame 0, SEI at every wave start
        assert b"".join(got[1:]).find(b"\x00\x00\x00\x01\x65") < 0

    def test_fused_gop_rejects_gop_one(self):
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        spec = FrameSpec(width=96, height=64, fps=30)
        with pytest.raises(ValueError, match="gop"):
            build_enhance_gop_fn(EnhancerConfig(op="none"), spec, 1)

    def test_relay_fused_gop_loopback(self):
        """relay --fused-encode with a GOP encoder: right IDR cadence
        on the wire, stream equal to the non-fused GOP relay."""
        import threading
        import time

        from opencv_opencl_tpu.apps import relay
        from opencv_opencl_tpu.io.rtp_h26x import H26xRtpReceiver

        def run_relay(port, extra):
            rx = H26xRtpReceiver("127.0.0.1", port, codec="h264",
                                 timeout=1.0)
            got = []

            def pump():
                t0 = time.time()
                while time.time() - t0 < 60 and len(got) < 6:
                    try:
                        au = rx.recv_access_unit()
                    except Exception:
                        continue
                    if au:
                        got.append(au)

            t = threading.Thread(target=pump, daemon=True)
            t.start()
            rc = relay.run([
                "--source=test", "--width=160", "--height=96",
                "--fps=30", "--op=histeq", "--batch=2", "--max-frames=6",
                f"--sink=rtp+h264://127.0.0.1:{port}",
                "--encoder=tpu:qp=30:gop=3", *extra])
            t.join(timeout=30)
            rx.close()
            assert rc == 0
            return got

        fused = run_relay(56065, ["--fused-encode"])
        plain = run_relay(56066, [])
        assert len(fused) == 6
        assert fused == plain
        for i, au in enumerate(fused):
            assert ((au[4] & 0x1F) == 7) == (i % 3 == 0)


class TestFusedRelay:
    def test_relay_fused_loopback(self):
        """relay --fused-encode streams decodable AUs over RTP, byte-
        identical to the unfused device-encoder relay on the same source."""
        import threading
        import time

        from opencv_opencl_tpu.apps import relay
        from opencv_opencl_tpu.io.rtp_h26x import H26xRtpReceiver

        def run_relay(port, extra):
            rx = H26xRtpReceiver("127.0.0.1", port, codec="h264",
                                 timeout=1.0)
            got = []

            def pump():
                t0 = time.time()
                while time.time() - t0 < 60 and len(got) < 6:
                    try:
                        au = rx.recv_access_unit()
                    except Exception:
                        continue
                    if au:
                        got.append(au)

            t = threading.Thread(target=pump, daemon=True)
            t.start()
            rc = relay.run([
                "--source=test", "--width=192", "--height=112",
                "--fps=30", "--op=clahe", "--batch=2", "--max-frames=6",
                f"--sink=rtp+h264://127.0.0.1:{port}",
                "--encoder=tpu:qp=30", *extra])
            t.join(timeout=30)
            rx.close()
            assert rc == 0
            return got

        fused = run_relay(56061, ["--fused-encode"])
        plain = run_relay(56062, [])
        assert len(fused) == 6
        assert fused == plain

    def test_relay_fused_requires_tpu_encoded_sink(self):
        from opencv_opencl_tpu.apps import relay

        rc = relay.run(["--source=test", "--max-frames=1",
                        "--sink=null", "--fused-encode"])
        assert rc == 2


class TestFusedGopSearch:
    def test_fused_gop_search_matches_unfused(self):
        """Fused enhance + GOP with device motion search (412-lane
        packing) streams byte-identical to enhance-then-
        TpuGopEncoder(search=R), across uneven batch splits."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            GOP_PACKED_LANES_MV, build_enhance_gop_fn)

        w, h, qp, gop = 96, 64, 30, 3
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="clahe", chroma=ChromaPolicy.PASSTHROUGH)
        rng = np.random.default_rng(33)
        base = rand_nv12_batch(w, h, 1, seed=33)[0]
        # panning luma so the search finds non-zero MVs post-enhance
        frames = np.stack([
            np.concatenate([np.roll(base[:h], 4 * i, 1),
                            np.roll(base[h:], 4 * i, 1)], 0)
            for i in range(7)])

        plain = build_enhance_fn(cfg, spec, donate=False)
        enh = np.asarray(plain(frames))
        ref_enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=8)
        want = [au for f in enh for au in ref_enc.encode(f)]

        fn = build_enhance_gop_fn(cfg, spec, gop, search=8)
        enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=8)
        recon = enc.initial_recon()
        idx, got = 0, []
        for lo, hi in ((0, 2), (2, 5), (5, 7)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(qp), idx,
                                *recon)
            packed = np.asarray(packed)
            assert packed.shape[-1] == GOP_PACKED_LANES_MV
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(packed[i]))
        assert got == want
        # the MV lanes must actually carry motion on panning content
        assert packed[:, :, :, 410:412].any()

    def test_fused_fastsub_matches_unfused(self):
        """Hierarchical quarter-pel search inside the fused device
        scan (subpel=3 flows through encode_p_levels unchanged):
        byte-identical to enhance-then-TpuGopEncoder(fastsub)."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        w, h, qp, gop = 96, 64, 30, 3
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="clahe",
                             chroma=ChromaPolicy.PASSTHROUGH)
        from tests.conftest import sinusoid_pan_frames
        frames = np.stack(sinusoid_pan_frames(w, h, 6, step=0.3,
                                              seed=6, terms=3))

        plain = build_enhance_fn(cfg, spec, donate=False)
        enh = np.asarray(plain(frames))
        ref_enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=3,
                                fastsub=True)
        want = [au for f in enh for au in ref_enc.encode(f)]

        fn = build_enhance_gop_fn(cfg, spec, gop, search=3, subpel=3)
        enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=3,
                            fastsub=True)
        recon = enc.initial_recon()
        idx, got = 0, []
        for lo, hi in ((0, 2), (2, 6)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(qp), idx,
                                *recon)
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(
                    np.asarray(packed)[i]))
        assert got == want

    def test_from_packed_rejects_bad_lane_count(self):
        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder

        enc = TpuGopEncoder(96, 64, qp=30, gop=3)
        with pytest.raises(ValueError, match="lanes"):
            enc.encode_from_packed(np.zeros((4, 6, 411), np.int16))


class TestFusedGopMultiRef:
    def test_fused_refs2_matches_unfused(self):
        """Fused enhance + GOP with TWO references (413-lane packing):
        byte-identical to enhance-then-TpuGopEncoder(refs=2) across
        uneven batch splits — both reference pictures must persist
        across batch boundaries in the device state."""
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            GOP_PACKED_LANES_MREF, build_enhance_gop_fn)

        w, h, qp, gop = 96, 64, 30, 4
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(op="none", chroma=ChromaPolicy.PASSTHROUGH)
        from tests.conftest import flicker_frames

        frames = np.stack(flicker_frames(w, h, 8, seed=51))

        ref_enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=4, refs=2)
        want = [au for f in frames for au in ref_enc.encode(f)]

        fn = build_enhance_gop_fn(cfg, spec, gop, search=4, refs=2)
        enc = TpuGopEncoder(w, h, qp=qp, gop=gop, search=4, refs=2)
        recon = enc.initial_recon()
        assert len(recon) == 6
        idx, got = 0, []
        # the split at 3 places a do_p2 frame (idx 3) right after a
        # batch boundary: its second reference crosses the boundary
        for lo, hi in ((0, 3), (3, 6), (6, 8)):
            packed, *recon = fn(frames[lo:hi], jnp.int32(qp), idx,
                                *recon)
            packed = np.asarray(packed)
            assert packed.shape[-1] == GOP_PACKED_LANES_MREF
            idx += hi - lo
            for i in range(hi - lo):
                got.extend(enc.encode_from_packed(packed[i]))
        assert got == want
        assert packed[:, :, :, 412].any(), "ref 1 never chosen"

    def test_fused_refs_validation(self):
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)

        spec = FrameSpec(width=96, height=64, fps=30)
        cfg = EnhancerConfig(op="none")
        with pytest.raises(ValueError, match="refs"):
            build_enhance_gop_fn(cfg, spec, 4, search=4, refs=3)
        with pytest.raises(ValueError, match="search"):
            build_enhance_gop_fn(cfg, spec, 4, refs=2)
