"""Intra_4x4 (``i4``) — conformance, decision and size-win tests.

The reference VCU's intra coding includes the full I_4x4 nine-mode set
(the hardware encoder behind /root/reference/OpenCVequalHist.cpp:308-332);
the in-repo analogue is io/h264_cavlc.py's ``i4`` option: per-4x4-block
best of the AVAILABLE spec 8.3.1.2 modes by the shared level-cost
proxy, competing against the I_16x16 candidate per MB.

Conformance bar (the repo invariant): libavcodec must decode every
stream with BIT-IDENTICAL luma reconstruction (deblocking off).  Every
one of the nine predictors is proven individually via the
``_I4_FORCE_MODE`` hook.
"""

import numpy as np
import pytest

from opencv_opencl_tpu.io import h264_cavlc as hc

W, H = 128, 96
MB_H = H // 16


def _content(kind: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "noise":
        y = rng.integers(0, 256, (H, W), np.uint8)
    elif kind == "structured":
        y = np.zeros((H, W), np.uint8)
        y[:, :32] = ((xx[:, :32] + yy[:, :32]) * 8 % 256)
        y[:, 32:64] = (yy[:, 32:64] * 16 % 256)
        y[:, 64:96] = (xx[:, 64:96] * 16 % 256)
        y[:, 96:] = ((xx[:, 96:] - yy[:, 96:]) * 8 % 256)
        y = np.clip(y.astype(np.int32) + rng.integers(-3, 4, y.shape),
                    0, 255).astype(np.uint8)
    else:
        raise ValueError(kind)
    uv = rng.integers(0, 256, (H // 2, W), np.uint8)
    return np.concatenate([y, uv])


def _au(nals):
    return (hc._START4 + hc.build_sps(W, H) + hc._START4
            + hc.build_pps_cavlc()
            + b"".join(hc._START4 + bytes(n) for n in nals))


def _decode_y(au: bytes, tmp_path) -> np.ndarray:
    import cv2

    p = tmp_path / "i4.h264"
    p.write_bytes(au + au)      # duplicate AU so the decoder flushes
    cap = cv2.VideoCapture(str(p))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    ok, f = cap.read()
    cap.release()
    assert ok, "libavcodec produced no frame"
    return f.reshape(-1, W)[:H].astype(np.int64)


class TestConformance:
    @pytest.mark.parametrize("qp", [22, 30, 38])
    @pytest.mark.parametrize("slices", [1, MB_H])
    def test_bitexact_recon(self, qp, slices, tmp_path):
        nv12 = _content("structured")
        nals, (ry, _, _) = hc.encode_frame_cavlc_slices(
            nv12, W, H, qp, slices=slices, return_recon=True, i4=True)
        dec = _decode_y(_au(nals), tmp_path)
        assert np.array_equal(dec, ry[:H, :W])

    @pytest.mark.parametrize("mode", list(range(9)))
    def test_every_predictor(self, mode, tmp_path):
        """Each spec 8.3.1.2 predictor individually, on noise (dense
        residuals exercise the cbp table too); every MB is forced to
        code Intra_4x4 so no predictor test is vacuous."""
        nv12 = _content("noise", seed=5)
        hc._I4_FORCE_MODE = mode
        hc._I4_FORCE_MB = True
        try:
            nals, (ry, _, _) = hc.encode_frame_cavlc_slices(
                nv12, W, H, 28, slices=1, return_recon=True, i4=True)
        finally:
            hc._I4_FORCE_MODE = None
            hc._I4_FORCE_MB = False
        dec = _decode_y(_au(nals), tmp_path)
        assert np.array_equal(dec, ry[:H, :W])

    def test_forced_mode_actually_used(self):
        """The force hooks are only meaningful if the forced mode
        dominates the coded MBs."""
        nv12 = _content("noise", seed=5)
        st = hc._MbEncoder(W, H, 28, i4=True)
        y = nv12[:H].astype(np.int64)
        uv = nv12[H:].reshape(H // 2, W // 2, 2)
        hc._I4_FORCE_MODE = 4
        hc._I4_FORCE_MB = True
        try:
            for mby in range(MB_H):
                w = hc._BitWriter()
                hc._slice_head_cavlc(w, 0, 28, first_mb=mby * (W // 16))
                for mbx in range(W // 16):
                    st.encode_mb(w, mby, mbx, y,
                                 uv[:, :, 0].astype(np.int64),
                                 uv[:, :, 1].astype(np.int64),
                                 first_mb_row=mby)
        finally:
            hc._I4_FORCE_MODE = None
            hc._I4_FORCE_MB = False
        coded = st.i4modes[np.repeat(st.is_i4, 4, 0).repeat(4, 1)]
        assert st.is_i4.all()
        assert (coded == 4).mean() > 0.5


class TestDecision:
    def test_i4_wins_on_structured_content(self):
        nv12 = _content("structured")
        n16 = sum(len(n) for n in hc.encode_frame_cavlc_slices(
            nv12, W, H, 28, slices=MB_H))
        n4 = sum(len(n) for n in hc.encode_frame_cavlc_slices(
            nv12, W, H, 28, slices=MB_H, i4=True))
        assert n4 < 0.95 * n16, (n4, n16)

    def test_recon_matches_choice(self):
        """i4=True with content where I_16x16 always wins must be
        byte-identical to i4=False (the trial rolls back recon)."""
        rng = np.random.default_rng(0)
        flat = np.full((H, W), 128, np.uint8)
        uv = rng.integers(0, 256, (H // 2, W), np.uint8)
        nv12 = np.concatenate([flat, uv])
        a = hc.encode_frame_cavlc_slices(nv12, W, H, 30, slices=1)
        b = hc.encode_frame_cavlc_slices(nv12, W, H, 30, slices=1,
                                         i4=True)
        assert [bytes(x) for x in a] == [bytes(x) for x in b]


class TestDeviceTwin:
    """ops/h264_levels.encode_levels(i4=True) — byte-exact stream twin
    of the oracle at one slice per MB row (the device contract)."""

    W2, H2 = 96, 64     # small: the i4 program unrolls 16 x 9 trials

    def _nv12(self, kind):
        rng = np.random.default_rng(9)
        yy, xx = np.mgrid[0:self.H2, 0:self.W2]
        if kind == "structured":
            y = ((xx * 2 + yy * 3) * 4 % 256).astype(np.uint8)
            y = np.clip(y.astype(np.int32)
                        + rng.integers(-4, 5, y.shape),
                        0, 255).astype(np.uint8)
        else:
            y = rng.integers(0, 256, (self.H2, self.W2), np.uint8)
        uv = rng.integers(0, 256, (self.H2 // 2, self.W2), np.uint8)
        return np.concatenate([y, uv])

    @pytest.mark.parametrize("qp", [24, 34])
    def test_stream_byte_identity(self, qp):
        from opencv_opencl_tpu.io.encoder import make_encoder

        nv12 = self._nv12("structured")
        mb_h = self.H2 // 16
        et = make_encoder(f"tpu:qp={qp}:i4", self.W2, self.H2, 30)
        eo = make_encoder(f"cavlc:qp={qp}:slices={mb_h}:i4",
                          self.W2, self.H2, 30)
        bt = b"".join(et.encode(nv12))
        bo = b"".join(eo.encode(nv12))
        assert bt == bo
        # the decision must actually pick I_4x4 somewhere
        lv = et._dispatch_levels(*et._pad(nv12.reshape(-1, self.W2)),
                                 qp)
        assert (np.asarray(lv["imode"]) == 0).any()

    def test_gop_stream_byte_identity(self):
        """tpu:gop with i4 IDRs: P frames reference the i4 recon."""
        from opencv_opencl_tpu.io.encoder import make_encoder

        rng = np.random.default_rng(11)
        base = ((np.mgrid[0:self.H2 + 16, 0:self.W2 + 16][1] * 3
                 + np.mgrid[0:self.H2 + 16, 0:self.W2 + 16][0] * 5)
                * 4 % 256).astype(np.uint8)
        frames = []
        for i in range(3):
            y = base[2 * i:2 * i + self.H2, 3 * i:3 * i + self.W2]
            uv = rng.integers(0, 256, (self.H2 // 2, self.W2),
                              np.uint8)
            frames.append(np.concatenate([y, uv]).copy())
        mb_h = self.H2 // 16

        def run(spec):
            enc = make_encoder(spec, self.W2, self.H2, 30)
            return b"".join(b"".join(enc.encode(f)) for f in frames)

        bt = run("tpu:qp=30:gop=3:search=2:i4")
        bo = run(f"cavlc:qp=30:gop=3:search=2:slices={mb_h}:i4")
        assert bt == bo


class TestIntegration:
    def test_make_encoder_flag(self, tmp_path):
        from opencv_opencl_tpu.io.encoder import make_encoder

        enc = make_encoder("cavlc:qp=30:i4", W, H, 30)
        aus = enc.encode(_content("structured"))
        assert len(aus) == 1 and aus[0][:4] == b"\x00\x00\x00\x01"

    def test_gop_idr_i4(self, tmp_path):
        """i4 IDR + P frames referencing its recon: the whole GOP
        stream must stay conformant with bit-identical recon."""
        import cv2

        from opencv_opencl_tpu.io.h264_inter import GopCavlcEncoder

        rng = np.random.default_rng(7)
        base = rng.integers(0, 256, (H + 16, W + 16), np.uint8)
        frames = []
        for i in range(3):
            y = base[4 + 2 * i:4 + 2 * i + H, 4 + 3 * i:4 + 3 * i + W]
            uv = np.full((H // 2, W), 128, np.uint8)
            frames.append(np.concatenate([y, uv]).copy())
        enc = GopCavlcEncoder(W, H, qp=30, gop=3, slices=MB_H,
                              search=2, i4=True)
        aus, recons = [], []
        for f in frames:
            aus += enc.encode(f)
            recons.append(enc._recon[0].astype(np.uint8))
        p = tmp_path / "g.h264"
        p.write_bytes(b"".join(aus) + aus[0])
        cap = cv2.VideoCapture(str(p))
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        for i in range(3):
            ok, f = cap.read()
            assert ok, f"decoder produced only {i}/3 frames"
            assert np.array_equal(f.reshape(-1, W)[:H], recons[i][:H]), \
                f"recon mismatch at frame {i}"
        cap.release()


class TestNativeI4Rows:
    """The C++ intra entropy rows (fp_cavlc_entropy_rows i4modes/cmode
    path) must be byte-identical to the Python from-levels writer."""

    def test_native_matches_python(self):
        from opencv_opencl_tpu import native

        if not native.available():
            pytest.skip(f"native lib unavailable: {native.build_error()}")
        import jax
        import jax.numpy as jnp

        from opencv_opencl_tpu.ops import h264_levels as hl

        rng = np.random.default_rng(3)
        yy, xx = np.mgrid[0:H, 0:W]
        y = ((xx * 2 + yy * 3) * 4 % 256).astype(np.uint8)
        cu = (np.mgrid[0:H // 2, 0:W // 2][0] * 8
              % 256).astype(np.uint8)
        cv_ = ((np.mgrid[0:H // 2, 0:W // 2][0] + 40) * 8
               % 256).astype(np.uint8)
        enc = jax.jit(lambda a, b, c, q: hl.encode_levels(
            a, b, c, q, i4=True, chromah=True))
        lv, imode, i4m, cm = enc(jnp.asarray(y), jnp.asarray(cu),
                                 jnp.asarray(cv_), jnp.int32(28))
        zdc, acz, czdc, cacz = (np.asarray(a, np.int64) for a in lv)
        imode = np.asarray(imode)
        i4m = np.asarray(i4m)
        cm = np.asarray(cm)
        assert (imode == 0).any() and (cm == 1).any()
        py = hc.encode_frame_from_levels(zdc, acz, czdc, cacz, 28,
                                         imode=imode, i4modes=i4m,
                                         cmode=cm)
        nat = native.cavlc_entropy_rows(zdc, acz, czdc, cacz, 28, 0,
                                        imode=imode, i4modes=i4m,
                                        cmode=cm)
        assert [bytes(a) for a in py] == [bytes(b) for b in nat]
