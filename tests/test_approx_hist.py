"""Opt-in approximate fast-histogram mode (selective downsampling,
arXiv:1709.04583): histograms from every Nth row, counts rescaled.

NOT part of the bit-exactness contract — the default (hist_downsample=1)
stays 0 LSB vs cv2 and is untouched; these tests pin the approximate
mode's determinism, cross-backend consistency, quality envelope, and
validation."""

from __future__ import annotations

import numpy as np
import pytest

from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.models.enhancer import EnhancerConfig, build_enhance_fn
from opencv_opencl_tpu.ops import clahe as cops


@pytest.fixture
def rng():
    return np.random.default_rng(42)


class TestClaheApprox:
    def test_cross_backend_consistency(self, rng):
        """The approximate mode is deterministic and identical between
        the histogram kernel (interpret mode) and the XLA formulation."""
        from opencv_opencl_tpu.ops.pallas import radix_hist

        y = rng.integers(0, 256, (128, 256), np.uint8)
        plan = cops.make_clahe_plan(128, 256, 2.0, (8, 8))  # tile_h 16
        hists = 2 * radix_hist.tile_histograms(
            cops._extend(y, plan)[::2], plan.tiles_y, plan.tiles_x,
            plan.tile_h // 2, plan.tile_w, interpret=True)
        a = np.asarray(cops._interpolate(
            y, cops._luts_from_hists(hists, plan), plan))
        b = np.asarray(cops.clahe_apply(y, plan, hist_rowstep=2))
        assert np.array_equal(a, b)

    @pytest.mark.parametrize("ds,mean_bound,max_bound",
                             [(2, 3.0, 32), (4, 6.5, 56)])
    def test_quality_envelope_noise(self, rng, ds, mean_bound, max_bound):
        """Worst case (pure noise) on TINY tiles (16x32 = 512 px — the
        estimation error shrinks with tile area: production 1080p tiles
        are 32k px and measured mean 0.47 / max 4 at ds=3)."""
        y = rng.integers(0, 256, (128, 256), np.uint8)
        plan = cops.make_clahe_plan(128, 256, 2.0, (8, 8))
        exact = np.asarray(cops.clahe_apply(y, plan))
        approx = np.asarray(cops.clahe_apply(y, plan, hist_rowstep=ds))
        d = np.abs(approx.astype(int) - exact.astype(int))
        assert d.mean() < mean_bound
        assert d.max() <= max_bound

    def test_smooth_image_nearly_exact(self):
        """A smooth gradient has row-stable statistics: the subsampled
        histogram is a near-perfect estimate."""
        yy, xx = np.mgrid[0:128, 0:256]
        y = ((yy + xx) % 256).astype(np.uint8)
        plan = cops.make_clahe_plan(128, 256, 2.0, (8, 8))
        exact = np.asarray(cops.clahe_apply(y, plan))
        approx = np.asarray(cops.clahe_apply(y, plan, hist_rowstep=2))
        d = np.abs(approx.astype(int) - exact.astype(int))
        assert d.mean() < 1.0
        assert d.max() <= 8

    def test_rowstep_must_divide_tile_h(self, rng):
        plan = cops.make_clahe_plan(120, 256, 2.0, (8, 8))  # tile_h 15
        y = rng.integers(0, 256, (120, 256), np.uint8)
        with pytest.raises(ValueError, match="divide"):
            cops.clahe_apply(y, plan, hist_rowstep=2)
        # 3 and 5 divide 15: accepted
        np.asarray(cops.clahe_apply(y, plan, hist_rowstep=3))


class TestEnhancerApprox:
    def test_clahe_pipeline_approx(self, rng):
        spec = FrameSpec(width=256, height=128, fps=30)
        base = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                              chroma=ChromaPolicy.PASSTHROUGH)
        fast = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                              chroma=ChromaPolicy.PASSTHROUGH,
                              hist_downsample=2)
        batch = rng.integers(0, 256, (2, spec.buffer_rows, 256), np.uint8)
        out_e = np.asarray(build_enhance_fn(base, spec, donate=False)(batch))
        out_a = np.asarray(build_enhance_fn(fast, spec, donate=False)(batch))
        d = np.abs(out_a[:, :128].astype(int) - out_e[:, :128].astype(int))
        assert d.mean() < 3.0
        # chroma passthrough identical
        assert np.array_equal(out_a[:, 128:], out_e[:, 128:])

    def test_histeq_pipeline_approx(self, rng):
        spec = FrameSpec(width=256, height=128, fps=30)
        fast = EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY,
                              hist_downsample=2)
        base = EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY)
        batch = rng.integers(0, 256, (2, spec.buffer_rows, 256), np.uint8)
        out_e = np.asarray(build_enhance_fn(base, spec, donate=False)(batch))
        out_a = np.asarray(build_enhance_fn(fast, spec, donate=False)(batch))
        d = np.abs(out_a[:, :128].astype(int) - out_e[:, :128].astype(int))
        assert d.mean() < 2.0
        assert d.max() <= 24

    def test_histeq_constant_frame_identity(self):
        """The all-one-value frame must map to itself in approx mode too
        (the OpenCV constant-image special case)."""
        spec = FrameSpec(width=256, height=128, fps=30)
        cfg = EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH,
                             hist_downsample=2)
        batch = np.full((1, spec.buffer_rows, 256), 77, np.uint8)
        out = np.asarray(build_enhance_fn(cfg, spec, donate=False)(batch))
        assert np.array_equal(out, batch)

    def test_bad_downsample_rejected(self):
        with pytest.raises(ValueError, match="hist_downsample"):
            EnhancerConfig(op="clahe", hist_downsample=0)
        spec = FrameSpec(width=256, height=120, fps=30)  # tile_h 15
        cfg = EnhancerConfig(op="clahe", hist_downsample=2)
        with pytest.raises(ValueError, match="divide"):
            build_enhance_fn(cfg, spec)

    def test_relay_flag(self, capsys):
        from opencv_opencl_tpu.apps import relay

        rc = relay.run([
            "--source=test", "--width=256", "--height=128", "--op=clahe",
            "--hist-downsample=2", "--max-frames=4", "--batch=2",
        ])
        assert rc == 0
        out = capsys.readouterr().out
        assert "APPROXIMATE histogram mode" in out


def test_unsupported_combinations_rejected(capsys):
    """The sharded and streaming paths are exact-only: the approximate
    flag must be refused, not silently ignored."""
    from opencv_opencl_tpu.apps import relay

    rc = relay.run(["--source=test", "--width=256", "--height=128",
                    "--op=clahe", "--hist-downsample=2", "--mesh=2x2",
                    "--batch=2", "--max-frames=2"])
    assert rc == 2
    rc = relay.run(["--source=test", "--width=256", "--height=128",
                    "--op=clahe", "--hist-downsample=2", "--ref-frame",
                    "--batch=2", "--max-frames=2"])
    assert rc == 2
    err = capsys.readouterr().err
    assert err.count("not supported") == 2

    from opencv_opencl_tpu.models.enhancer import EnhancerConfig
    from opencv_opencl_tpu.parallel.mesh import make_mesh
    from opencv_opencl_tpu.parallel.sharded import build_sharded_pipeline

    cfg = EnhancerConfig(op="clahe", hist_downsample=2)
    with pytest.raises(ValueError, match="sharded"):
        build_sharded_pipeline(cfg, 128, 256, make_mesh(2))


def test_histeq_ref_frame_downsample_rejected():
    """histeq + use_ref_frame + downsample must be refused, not run the
    exact path under an APPROXIMATE banner (review finding)."""
    from opencv_opencl_tpu.apps import relay

    spec = FrameSpec(width=256, height=128, fps=30)
    cfg = EnhancerConfig(op="histeq", use_ref_frame=True, hist_downsample=2)
    with pytest.raises(ValueError, match="ref_frame"):
        build_enhance_fn(cfg, spec)
    rc = relay.run(["--source=test", "--width=256", "--height=128",
                    "--op=histeq", "--ref-frame", "--hist-downsample=2",
                    "--max-frames=2", "--batch=2"])
    assert rc == 2
