"""Device H.264 level-computation parity (ops/h264_levels.py).

Contract chain: the device path (JAX levels + entropy coding) must be
BYTE-IDENTICAL to ``encode_frame_cavlc_slices(slices=mb_h)`` — the
per-MB-row multi-slice oracle — which is itself decoder-conformance
proven through libavcodec (tests/test_cavlc.py).  Both entropy coders
are diffed: the pure-Python ``encode_frame_from_levels`` and the native
``fp_cavlc_entropy_rows``.  On CPU the jit runs on the virtual-device
backend; the arithmetic is integer-only, so platform cannot change the
bytes (chip_smoke.py checks them on the GPU).
"""

from __future__ import annotations

import numpy as np
import pytest

from opencv_opencl_tpu import native
from opencv_opencl_tpu.io.h264_cavlc import (
    CavlcH264Encoder, TpuCavlcEncoder, encode_frame_cavlc_slices,
    encode_frame_from_levels)
from opencv_opencl_tpu.io.h264_pcm import _START4
from opencv_opencl_tpu.ops.h264_levels import (
    encode_levels_nv12, LevelArrays)


def smooth_nv12(w, h, seed=0, noise=12.0):
    rng = np.random.default_rng(seed)
    gx = np.linspace(0, 255, w)[None, :]
    gy = np.linspace(0, 80, h)[:, None]
    y = np.clip(gx + gy + rng.normal(0, noise, (h, w)), 0, 255)
    uv = np.clip(128 + rng.normal(0, noise, (h // 2, w)), 0, 255)
    return np.concatenate([y, uv], axis=0).astype(np.uint8)


def rand_nv12(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h * 3 // 2, w), np.uint8)


def levels_np(nv12, w, h, qp):
    """(LevelArrays of numpy arrays, imode numpy plane)."""
    lv, imode = encode_levels_nv12(nv12, w, h, qp)
    return (LevelArrays(*(np.asarray(a) for a in lv)),
            np.asarray(imode))


def oracle_rows(nv12, w, h, qp, idr=0):
    return [bytes(n) for n in encode_frame_cavlc_slices(
        nv12, w, h, qp, idr_pic_id=idr, slices=h // 16)]


class TestLevelsParity:
    """JAX levels + Python entropy == the multi-slice oracle."""

    @pytest.mark.parametrize("qp", [0, 7, 18, 28, 37, 46, 51])
    def test_bytes_identical_across_qp(self, qp):
        w, h = 96, 64
        f = smooth_nv12(w, h, seed=qp)
        lv, im = levels_np(f, w, h, qp)
        got = encode_frame_from_levels(*lv, qp, idr_pic_id=0, imode=im)
        assert got == oracle_rows(f, w, h, qp)

    @pytest.mark.parametrize("seed", [1, 2])
    def test_random_noise(self, seed):
        w, h = 176, 144
        f = rand_nv12(w, h, seed)
        lv, im = levels_np(f, w, h, 24)
        assert encode_frame_from_levels(*lv, 24, idr_pic_id=1, imode=im) == \
            oracle_rows(f, w, h, 24, idr=1)

    def test_flat_and_checkerboard(self):
        w, h = 64, 48
        flat = np.full((h * 3 // 2, w), 77, np.uint8)
        lv, im = levels_np(flat, w, h, 30)
        assert encode_frame_from_levels(*lv, 30, idr_pic_id=0, imode=im) == \
            oracle_rows(flat, w, h, 30)
        cb = np.zeros((h * 3 // 2, w), np.uint8)
        cb[:h][(np.add.outer(np.arange(h), np.arange(w)) & 1) == 0] = 255
        cb[h:] = 128
        lv, im = levels_np(cb, w, h, 8)
        assert encode_frame_from_levels(*lv, 8, idr_pic_id=0, imode=im) == \
            oracle_rows(cb, w, h, 8)

    def test_black_qp0_level_clamp(self):
        """Black frame at QP 0: the DC path hits the +-2063 escape
        clamp (the pathological case the clamp exists for)."""
        w, h = 64, 48
        f = np.zeros((h * 3 // 2, w), np.uint8)
        lv, im = levels_np(f, w, h, 0)
        assert encode_frame_from_levels(*lv, 0, idr_pic_id=0, imode=im) == \
            oracle_rows(f, w, h, 0)

    def test_single_mb_row_and_column(self):
        for (w, h) in [(256, 16), (16, 128), (16, 16)]:
            f = smooth_nv12(w, h, seed=3)
            lv, im = levels_np(f, w, h, 26)
            assert encode_frame_from_levels(*lv, 26, idr_pic_id=0, imode=im) == \
                oracle_rows(f, w, h, 26)


@pytest.mark.skipif(
    not (native.available() and native.has_cavlc()),
    reason=f"native runtime unavailable: {native.build_error()}")
class TestNativeEntropy:
    """fp_cavlc_entropy_rows == the Python entropy writer (and so the
    oracle), single-threaded and threaded."""

    @pytest.mark.parametrize("qp", [0, 12, 28, 44, 51])
    def test_bytes_identical(self, qp):
        w, h = 176, 144
        f = smooth_nv12(w, h, seed=qp + 100)
        lv, im = levels_np(f, w, h, qp)
        ref = oracle_rows(f, w, h, qp, idr=1)
        got = native.cavlc_entropy_rows(*lv, qp, 1, threads=1,
                                        imode=im)
        assert got == ref

    def test_threaded_matches_and_workspace_reuse(self):
        w, h, qp = 176, 144, 20
        ws: dict = {}
        for seed in range(3):
            f = rand_nv12(w, h, seed)
            lv, im = levels_np(f, w, h, qp)
            ref = oracle_rows(f, w, h, qp)
            got = native.cavlc_entropy_rows(*lv, qp, 0, threads=4,
                                            workspace=ws, imode=im)
            assert got == ref


class TestTpuCavlcEncoder:
    def test_au_identical_to_cpu_encoder(self):
        """The encoder protocol end-to-end (odd geometry exercises the
        pad/crop path): device AUs == CavlcH264Encoder(slices=mb_h)."""
        w, h = 190, 106  # pads to 192x112 -> 7 MB rows
        cpu = CavlcH264Encoder(w, h, qp=27, slices=112 // 16,
                               native="never")
        tpu = TpuCavlcEncoder(w, h, qp=27)
        for seed in range(2):
            f = smooth_nv12(w, h, seed=seed + 7)
            assert tpu.encode(f) == cpu.encode(f)

    def test_rate_control_inherited(self):
        w, h = 64, 48
        enc = TpuCavlcEncoder(w, h, bitrate_kbps=50, fps=30.0)
        qp0 = enc.qp
        enc.encode(rand_nv12(w, h, 0))  # noise blows the tiny budget
        assert enc.qp > qp0

    def test_decodes_through_libavcodec(self, tmp_path):
        cv2 = pytest.importorskip("cv2")
        w, h = 96, 64
        f = smooth_nv12(w, h, seed=11)
        enc = TpuCavlcEncoder(w, h, qp=24)
        (au,) = enc.encode(f)
        # libavcodec holds a frame of delay: double the AU
        p = tmp_path / "tpu.h264"
        p.write_bytes(au + au)
        cap = cv2.VideoCapture(str(p))
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        ok, dec = cap.read()
        cap.release()
        assert ok
        y = dec[:h] if dec.ndim == 2 else cv2.cvtColor(
            dec, cv2.COLOR_BGR2YUV_I420)[:h]
        # decoder output == the oracle encoder's reconstruction
        from opencv_opencl_tpu.io.h264_cavlc import (
            encode_frame_cavlc_slices as _efs)
        f16 = CavlcH264Encoder(w, h, qp=24, native="never")._pad(f)[0]
        _, (ry, _, _) = _efs(f16, w, h, 24, idr_pic_id=0,
                             slices=h // 16, return_recon=True)
        assert np.array_equal(y[:h, :w], ry[:h, :w].astype(np.uint8))

    def test_make_encoder_tpu_backend(self):
        from opencv_opencl_tpu.io.encoder import make_encoder

        enc = make_encoder("tpu:qp=30", 64, 48)
        assert isinstance(enc, TpuCavlcEncoder)
        (au,) = enc.encode(smooth_nv12(64, 48))
        assert au.startswith(_START4)
        with pytest.raises(ValueError):
            make_encoder("tpu:qp=77", 64, 48)
        with pytest.raises(ValueError):
            make_encoder("tpu", 64, 48, codec="h265")

    def test_overlap_stream_identical_with_one_frame_delay(self):
        """tpu:overlap emits the same AUs shifted by one write: [] on
        the first encode, flush drains the tail, bytes unchanged."""
        from opencv_opencl_tpu.io.encoder import make_encoder

        w, h = 96, 64
        frames = [smooth_nv12(w, h, seed=s) for s in range(4)]
        sync = make_encoder("tpu:qp=26", w, h)
        want = [au for f in frames for au in sync.encode(f)]
        pipe = make_encoder("tpu:qp=26:overlap", w, h)
        assert pipe.encode(frames[0]) == []
        got = [au for f in frames[1:] for au in pipe.encode(f)]
        got += pipe.flush()
        assert got == want
        assert pipe.flush() == []  # idempotent tail drain

    def test_overlap_rate_control_lags_one_frame(self):
        w, h = 64, 48
        enc = TpuCavlcEncoder(w, h, bitrate_kbps=50, fps=30.0,
                              overlap=True)
        qp0 = enc.qp
        enc.encode(rand_nv12(w, h, 0))
        assert enc.qp == qp0          # nothing assembled yet
        enc.encode(rand_nv12(w, h, 1))
        assert enc.qp > qp0           # frame 0's AU blew the budget


class TestIntraHorizontal:
    def test_h_mode_chosen_and_conformant(self, tmp_path):
        """A vertical luminance ramp (rows constant) makes HORIZONTAL
        prediction near-perfect: the mode must be chosen, the stream
        must shrink vs content where only DC fires, and the decode
        must stay bit-exact through libavcodec."""
        import cv2

        w, h = 96, 64
        y = np.repeat(np.linspace(20, 235, h).astype(np.uint8)[:, None],
                      w, 1)
        nv12 = np.concatenate(
            [y, np.full((h // 2, w), 128, np.uint8)], 0)
        lv, im = levels_np(nv12, w, h, 28)
        assert (np.asarray(im) == 1).any(), "H mode never selected"
        enc = TpuCavlcEncoder(w, h, qp=26)
        aus = [enc.encode(nv12)[0] for _ in range(2)]
        p = tmp_path / "ih.h264"
        p.write_bytes(b"".join(aus) + aus[-1])
        cap = cv2.VideoCapture(str(p))
        assert cap.isOpened()
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        ok, d = cap.read()
        cap.release()
        assert ok
        # the decoded luma must equal the oracle's reconstruction —
        # THE conformance assertion for the H reconstruction path
        cpu = CavlcH264Encoder(w, h, qp=26, slices=h // 16,
                               native="never")
        assert cpu.encode(nv12) == [aus[0]]
        from opencv_opencl_tpu.io.h264_cavlc import (
            encode_frame_cavlc_slices)

        _, recon = encode_frame_cavlc_slices(
            nv12, w, h, 26, idr_pic_id=0, slices=h // 16,
            return_recon=True)
        assert np.array_equal(d[:h, :w].astype(np.int64),
                              recon[0][:h, :w])

    def test_h_mode_smaller_than_dc_only_content(self):
        """IDR size on the ramp must be well under the same encoder's
        size on 90-degree-rotated content (where H cannot help and DC
        does the same work) — a self-relative compression check."""
        w, h = 96, 64
        ramp_v = np.repeat(
            np.linspace(20, 235, h).astype(np.uint8)[:, None], w, 1)
        ramp_h = np.repeat(
            np.linspace(20, 235, w).astype(np.uint8)[None, :], h, 0)
        uv = np.full((h // 2, w), 128, np.uint8)
        enc = CavlcH264Encoder(w, h, qp=28, slices=h // 16,
                               native="never")
        sz_v = len(enc.encode(np.concatenate([ramp_v, uv], 0))[0])
        sz_h = len(enc.encode(np.concatenate([ramp_h, uv], 0))[0])
        # the vertical ramp rides H prediction; the horizontal ramp
        # has no top neighbor (one slice per row) so DC must code it
        assert sz_v < 0.7 * sz_h, (sz_v, sz_h)


class TestSadAndUnroll:
    """Motion-search SAD fields are int32 block sums; the MB-column scan
    unroll is chosen from the platform."""

    @staticmethod
    def _diff(rng, h, w):
        return rng.integers(-255, 256, (h, w)).astype(np.int16)

    @pytest.mark.parametrize("h,w,b", [(32, 48, 16), (64, 1920, 16),
                                       (48, 32, 8), (16, 16, 4)])
    def test_sad_field(self, h, w, b):
        import jax.numpy as jnp

        from opencv_opencl_tpu.ops.h264_levels import _sad_field

        ad = self._diff(np.random.default_rng(h * w + b), h, w)
        ref = np.abs(ad.astype(np.int64)).reshape(
            h // b, b, w // b, b).sum(axis=(1, 3))
        got = np.asarray(_sad_field(jnp.asarray(ad), b))
        assert got.dtype == np.int32 and np.array_equal(got, ref)

    def test_sad_field_extreme(self):
        import jax.numpy as jnp

        from opencv_opencl_tpu.ops.h264_levels import _sad_field

        ad = np.full((32, 32), -255, np.int16)
        assert (np.asarray(_sad_field(jnp.asarray(ad), 16)) == 65280).all()

    @pytest.mark.parametrize("h,w", [(16, 16), (48, 80), (1088, 64)])
    def test_sad_quad_fields(self, h, w):
        import jax.numpy as jnp

        from opencv_opencl_tpu.ops.h264_levels import _sad_quad_fields

        ad = self._diff(np.random.default_rng(h + w), h, w)
        a = np.abs(ad.astype(np.int64))
        ref = np.zeros((4, h // 16, w // 16), np.int64)
        for qi, (oy, ox) in enumerate(((0, 0), (0, 8), (8, 0), (8, 8))):
            blk = a.reshape(h // 16, 16, w // 16, 16)[:, oy:oy + 8, :,
                                                      ox:ox + 8]
            ref[qi] = blk.sum(axis=(1, 3))
        got = _sad_quad_fields(jnp.asarray(ad))
        for qi in range(4):
            assert np.array_equal(np.asarray(got[qi]), ref[qi]), qi

    @pytest.mark.parametrize("backend,unroll", [("gpu", 8), ("cpu", 1)])
    def test_scan_unroll_by_platform(self, monkeypatch, backend, unroll):
        import jax

        from opencv_opencl_tpu.ops import h264_levels

        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert h264_levels._scan_unroll() == unroll
