"""CPB/HRD leaky-bucket rate control (io/h264_hrd.py).

The reference's VCU enforces ``control-rate=low-latency cpb-size=500
initial-delay=250`` (OpenCVequalHist.cpp:313-314).  The bar here: over
ADVERSARIAL content (scene cuts between noise patterns), an
INDEPENDENT decoder-side HRD simulation — arrival over a busy channel
vs. the removal schedule, written from first principles, not the
encoder's own model — shows ZERO violations at the declared CPB; the
VUI-carrying SPS decodes bit-exactly through libavcodec; and the device
path stays byte-identical to the oracle.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

from opencv_opencl_tpu.io.h264_cavlc import CavlcH264Encoder
from opencv_opencl_tpu.io.h264_hrd import CpbModel, HrdParams
from opencv_opencl_tpu.io.h264_inter import GopCavlcEncoder, TpuGopEncoder

from tests.test_h264_inter import decode_frames


def adversarial(w, h, n, seed=7):
    """Scene cuts every 3 frames — the burst generator any CPB
    controller must survive."""
    rng = np.random.default_rng(seed)
    scenes = [rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
              for _ in range(4)]
    g = np.clip(np.linspace(0, 255, w)[None, :]
                + np.zeros((h * 3 // 2, 1)), 0, 255).astype(np.uint8)
    scenes.append(g)
    return [scenes[(i // 3) % len(scenes)] for i in range(n)]


def simulate_hrd(sizes_bits, bitrate_bps, fps, delay_s, cpb_bits):
    """First-principles decoder-side check: frame k's bits arrive over
    a busy channel no earlier than its capture tick and must complete
    by the removal deadline ``delay + k/fps``; no picture may exceed
    the CPB.  Returns the violation count."""
    T = Fraction(1, 1) / Fraction(fps).limit_denominator(65535)
    arr_done = Fraction(0)
    viol = 0
    for k, b in enumerate(sizes_bits):
        start = max(arr_done, k * T)
        arr_done = start + Fraction(b, bitrate_bps)
        if arr_done > Fraction(delay_s) + k * T:
            viol += 1
        if b > cpb_bits:
            viol += 1
    return viol


class TestModel:
    def test_budget_and_slack(self):
        m = CpbModel(1000, cpb_ms=500, initial_delay_ms=250, fps=25.0)
        # empty schedule: budget = min(R*D, cpb) = min(250k, 500k)
        assert m.budget_bits() == 250_000
        assert not m.add_frame(250_000)       # exactly at the deadline
        # that burst consumed the whole delay; one tick drains 40 ms
        assert m.budget_bits() == 40_000
        assert m.add_frame(250_000)           # now it violates
        assert m.violations == 1

    def test_single_picture_cpb_cap(self):
        m = CpbModel(1000, cpb_ms=100, initial_delay_ms=100, fps=1.0)
        assert m.budget_bits() == 100_000     # cpb caps below R*D
        assert m.add_frame(150_000)

    def test_params_validation(self):
        with pytest.raises(ValueError, match="cannot exceed"):
            HrdParams(1000, cpb_ms=200, initial_delay_ms=300, fps=30)
        with pytest.raises(ValueError, match=">= 1 ms"):
            HrdParams(1000, cpb_ms=0, initial_delay_ms=0, fps=30)
        p = HrdParams(999, cpb_ms=500, initial_delay_ms=250, fps=30)
        assert p.decl_bitrate >= 999_000      # rounded UP to the grid
        assert p.decl_bitrate % 64 == 0
        assert p.decl_cpb_bits % 16 == 0


class TestZeroViolations:
    @pytest.mark.parametrize("cls", [GopCavlcEncoder, TpuGopEncoder])
    def test_gop_adversarial(self, cls):
        w, h, fps = 128, 96, 30.0
        kw = dict(slices=h // 16) if cls is GopCavlcEncoder else {}
        enc = cls(w, h, qp=26, gop=6, bitrate_kbps=400, fps=fps,
                  cpb_ms=500, initial_delay_ms=250, **kw)
        sizes = [8 * len(enc.encode(f)[0])
                 for f in adversarial(w, h, 30)]
        assert simulate_hrd(sizes, 400_000, fps, Fraction(250, 1000),
                            400_000 * 500 // 1000) == 0
        assert enc._cpb.violations == 0
        # the controller must actually have intervened on this content
        assert enc.qp > 26

    def test_intra_encoder_adversarial(self):
        # all-IDR noise at 128x96 has a ~23 kbit/frame floor even at
        # QP 51, so the channel must sustain at least that (~700 kbps
        # at 30 fps); below the floor NO controller can comply — the
        # infeasible-config behavior is pinned separately below
        w, h, fps = 128, 96, 30.0
        enc = CavlcH264Encoder(w, h, qp=24, bitrate_kbps=1000, fps=fps,
                               cpb_ms=400, initial_delay_ms=200)
        sizes = [8 * len(enc.encode(f)[0])
                 for f in adversarial(w, h, 20, seed=3)]
        assert simulate_hrd(sizes, 1_000_000, fps, Fraction(200, 1000),
                            1_000_000 * 400 // 1000) == 0
        assert enc._cpb.violations == 0

    def test_infeasible_channel_is_reported_not_hidden(self):
        """When even QP 51 cannot fit the channel, the model must
        COUNT the violations (honest telemetry) rather than stall."""
        w, h = 128, 96
        enc = CavlcH264Encoder(w, h, qp=24, bitrate_kbps=300, fps=30.0,
                               cpb_ms=400, initial_delay_ms=200)
        for f in adversarial(w, h, 10, seed=3):
            enc.encode(f)
        assert enc.qp == 51
        assert enc._cpb.violations > 0

    def test_tpu_byte_identical_to_oracle(self):
        w, h = 128, 96
        frames = adversarial(w, h, 12)
        a = GopCavlcEncoder(w, h, qp=26, gop=6, bitrate_kbps=400,
                            fps=30.0, cpb_ms=500, slices=h // 16)
        b = TpuGopEncoder(w, h, qp=26, gop=6, bitrate_kbps=400,
                          fps=30.0, cpb_ms=500)
        for i, f in enumerate(frames):
            assert a.encode(f) == b.encode(f), f"frame {i}"
        assert a.qp == b.qp

    def test_decode_conformance_with_vui(self, tmp_path):
        """The HRD-carrying SPS must decode bit-exactly (VUI syntax is
        part of the SPS the conformance decoder parses)."""
        w, h = 128, 96
        frames = adversarial(w, h, 8)
        enc = GopCavlcEncoder(w, h, qp=26, gop=6, bitrate_kbps=400,
                              fps=30.0, cpb_ms=500, slices=h // 16)
        aus, recons = [], []
        for f in frames:
            aus.append(enc.encode(f)[0])
            recons.append(np.asarray(enc._recon[0]).copy())
        dec = decode_frames(b"".join(aus), tmp_path, 8, aus[-1])
        for i, d in enumerate(dec):
            assert np.array_equal(d[:h, :w].astype(np.int64),
                                  recons[i][:h, :w]), f"frame {i}"


class TestRefusals:
    def test_cpb_needs_bitrate(self):
        with pytest.raises(ValueError, match="bitrate"):
            CavlcH264Encoder(64, 48, qp=30, cpb_ms=500)
        with pytest.raises(ValueError, match="bitrate"):
            TpuGopEncoder(64, 48, qp=30, gop=8, cpb_ms=500)

    def test_cpb_refuses_overlap(self):
        with pytest.raises(ValueError, match="overlap"):
            TpuGopEncoder(64, 48, gop=8, bitrate_kbps=400,
                          cpb_ms=500, overlap=True)

    def test_initdelay_needs_cpb(self):
        with pytest.raises(ValueError, match="initdelay requires cpb"):
            CavlcH264Encoder(64, 48, bitrate_kbps=400,
                             initial_delay_ms=100)

    def test_spec_strings(self):
        from opencv_opencl_tpu.io.encoder import make_encoder

        e = make_encoder("cavlc:cpb=500:initdelay=250", 64, 48,
                         bitrate_kbps=400)
        assert e._cpb is not None
        assert e._cpb.params.initial_delay_ms == 250
        e = make_encoder("tpu:gop=8:cpb=500", 64, 48, bitrate_kbps=400)
        assert isinstance(e, TpuGopEncoder) and e._cpb is not None
        with pytest.raises(ValueError, match="bitrate"):
            make_encoder("cavlc:qp=30:cpb=500", 64, 48)
