"""The flagship Enhancer pipeline: NV12 in -> enhanced NV12 out.

Covers the four reference relay behaviors: histeq+gray (OpenCVequalHist),
histeq+passthrough (improvement/nextimprovement), CLAHE (CLAHECompare),
and the two-input ref-frame streaming mode.
"""

import cv2
import numpy as np
import pytest

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.models import Enhancer, EnhancerConfig
from tests.conftest import assert_clahe_close

SPEC = FrameSpec(width=64, height=48, fps=30)


@pytest.fixture
def nv12_batch(rng):
    return rng.integers(0, 256, (4, SPEC.buffer_rows, SPEC.width), dtype=np.uint8)


def test_histeq_gray(nv12_batch):
    enh = Enhancer(EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY), SPEC)
    out = np.asarray(enh.process_batch(nv12_batch))
    for i in range(4):
        assert np.array_equal(out[i, :48], cv2.equalizeHist(nv12_batch[i, :48]))
    assert (out[:, 48:] == 128).all()


def test_histeq_passthrough(nv12_batch):
    enh = Enhancer(
        EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH), SPEC
    )
    out = np.asarray(enh.process_batch(nv12_batch))
    assert np.array_equal(out[:, 48:], nv12_batch[:, 48:])


def test_clahe_passthrough(nv12_batch):
    enh = Enhancer(
        EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                       chroma=ChromaPolicy.PASSTHROUGH),
        SPEC,
    )
    out = np.asarray(enh.process_batch(nv12_batch))
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for i in range(4):
        assert_clahe_close(out[i, :48], c.apply(nv12_batch[i, :48]))


def test_none_op_is_identity(nv12_batch):
    enh = Enhancer(
        EnhancerConfig(op="none", chroma=ChromaPolicy.PASSTHROUGH), SPEC
    )
    assert np.array_equal(np.asarray(enh.process_batch(nv12_batch)), nv12_batch)


def test_ref_frame_mode(nv12_batch):
    """Frame i is mapped with frame i-1's LUT (frame 0 with its own)."""
    enh = Enhancer(
        EnhancerConfig(op="histeq", use_ref_frame=True,
                       chroma=ChromaPolicy.PASSTHROUGH),
        SPEC,
    )
    out = np.asarray(enh.process_batch(nv12_batch))
    ys = nv12_batch[:, :48]
    assert np.array_equal(out[0, :48], golden.equalize_hist(ys[0], ys[0]))
    for i in range(1, 4):
        assert np.array_equal(out[i, :48], golden.equalize_hist(ys[i], ys[i - 1]))


def test_single_frame_api(nv12_batch):
    enh = Enhancer(EnhancerConfig(op="histeq"), SPEC)
    out = np.asarray(enh.process_frame(nv12_batch[0]))
    assert out.shape == (SPEC.buffer_rows, SPEC.width)


def test_bad_op_rejected():
    with pytest.raises(ValueError):
        EnhancerConfig(op="sharpen")


def test_presets_registry():
    """Every reference program/binary has a named preset that builds."""
    from opencv_opencl_tpu.models.presets import PRESETS, build

    expected = {"histequalize", "color", "next", "opencl", "improvement",
                "imp", "clahecompare", "airplanmp4"}
    assert expected == set(PRESETS)
    enh, spec, enc = build("clahecompare")
    assert (spec.width, spec.height, spec.fps) == (1280, 720, 30)
    assert enh.cfg.op == "clahe" and enh.cfg.clip_limit == 2.0
    assert PRESETS["imp"].width == 3840 and PRESETS["imp"].tuned_emit
    assert PRESETS["histequalize"].enhancer.chroma.value == "gray"


def test_build_enhance_fn_donates_input_buffer():
    """The jitted step aliases input->output (no second frame buffer in
    device memory): the compiled HLO must carry the input_output_alias
    directive."""
    import numpy as np

    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.models.enhancer import EnhancerConfig, build_enhance_fn

    spec = FrameSpec(width=64, height=48, fps=30)
    cfg = EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY)
    fn = build_enhance_fn(cfg, spec)
    batch = np.zeros((2, spec.buffer_rows, spec.width), np.uint8)
    hlo = fn.lower(batch).as_text()
    assert "tf.aliasing_output" in hlo  # lowered alias annotation
    # and the non-donating variant must not alias
    fn2 = build_enhance_fn(cfg, spec, donate=False)
    assert "tf.aliasing_output" not in fn2.lower(batch).as_text()


class TestStreamingClahe:
    """Ref-frame streaming CLAHE (the accel.cpp two-input hook for CLAHE)."""

    def make(self, w=128, h=96):
        from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu.models.enhancer import (
            EnhancerConfig, StreamingEnhancer,
        )

        cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                             chroma=ChromaPolicy.PASSTHROUGH,
                             use_ref_frame=True)
        from opencv_opencl_tpu.core.frames import FrameSpec as FS

        return StreamingEnhancer(cfg, FS(width=w, height=h, fps=30))

    def test_static_scene_converges_to_cv2(self, rng):
        import cv2

        from tests.conftest import assert_clahe_close

        se = self.make()
        frame = rng.integers(0, 256, (144, 128), dtype=np.uint8)
        batch = np.stack([frame] * 4)
        out = np.asarray(se.process_batch(batch))
        ref = cv2.createCLAHE(2.0, (8, 8)).apply(frame[:96])
        for i in range(1, 4):  # frames >= 1 use frame's own stats
            assert_clahe_close(out[i, :96], ref)
        assert np.array_equal(out[:, 96:], batch[:, 96:])  # uv passthrough

    def test_state_carries_across_batches(self, rng):
        import cv2

        from tests.conftest import assert_clahe_close

        se = self.make()
        frame = rng.integers(0, 256, (144, 128), dtype=np.uint8)
        se.process_batch(np.stack([frame] * 2))
        out2 = np.asarray(se.process_batch(np.stack([frame] * 2)))
        ref = cv2.createCLAHE(2.0, (8, 8)).apply(frame[:96])
        assert_clahe_close(out2[0, :96], ref)  # batch-0 state flowed in

    def test_moving_scene_uses_previous_frame_luts(self, rng):
        from opencv_opencl_tpu.core import golden
        from opencv_opencl_tpu.ops import clahe as cops
        from tests.conftest import assert_clahe_close

        se = self.make()
        frames = [rng.integers(0, 256, (144, 128), dtype=np.uint8)
                  for _ in range(3)]
        out = np.asarray(se.process_batch(np.stack(frames)))
        # golden two-pass ref model: luts from frame i-1 applied to frame i
        plan = cops.make_clahe_plan(96, 128, 2.0, (8, 8))
        for i in (1, 2):
            luts, th, tw = golden.clahe_luts(frames[i - 1][:96], 2.0, (8, 8))
            ref = golden.clahe_apply_luts(frames[i][:96], luts, th, tw)
            assert_clahe_close(out[i, :96], ref)

    def test_reset(self, rng):
        se = self.make()
        f = rng.integers(0, 256, (144, 128), dtype=np.uint8)
        a = np.asarray(se.process_batch(np.stack([f])))
        se.reset()
        b = np.asarray(se.process_batch(np.stack([f])))
        assert np.array_equal(a, b)  # same initial state -> same output
