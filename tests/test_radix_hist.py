"""The radix-16 histogram kernel and the CLAHE stages around it.

The kernel is compiled through Triton, which exists only for the GPU, so
here it runs in Pallas interpret mode; on the card ``chip_smoke.py`` runs
it compiled (``tests/test_gpu.py``).  Histograms are integer-exact:
tolerance 0.  Lowering for CUDA needs no card, so the tests also check
that the kernel lowers at the widths users run.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.ops import clahe as cops
from opencv_opencl_tpu.ops import histogram as hops
from opencv_opencl_tpu.ops.pallas import radix_hist
from tests.conftest import assert_clahe_close

GEOMETRIES = [
    (96, 128, 2.0, (8, 8)),
    (97, 131, 2.0, (8, 8)),      # odd: reflect-padded tiles
    (64, 256, 3.0, (4, 4)),
    (120, 256, 40.0, (8, 8)),    # cv2 default clip
    (33, 47, 2.5, (3, 5)),       # asymmetric grid
    (270, 480, 2.0, (8, 8)),     # 4K tile-scaled geometry
]


def _golden_tile_hists(ext, ty, tx, th, tw):
    return np.stack([golden.hist256(np.ascontiguousarray(
        ext[a * th:(a + 1) * th, b * tw:(b + 1) * tw]))
        for a in range(ty) for b in range(tx)])


def _kernel(ext, ty, tx, th, tw):
    return np.asarray(radix_hist.tile_histograms(
        jnp.asarray(ext), ty, tx, th, tw, interpret=True))


class TestKernelExact:
    @pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
    def test_clahe_tiles(self, rng, h, w, clip, grid):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        plan = cops.make_clahe_plan(h, w, clip, grid)
        ext = np.asarray(cops._extend(jnp.asarray(y), plan))
        args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
        assert np.array_equal(_kernel(ext, *args),
                              _golden_tile_hists(ext, *args))

    @pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
    def test_batched(self, rng, h, w, clip, grid):
        plan = cops.make_clahe_plan(h, w, clip, grid)
        args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
        ext = rng.integers(0, 256, (3, plan.tiles_y * plan.tile_h,
                                    plan.tiles_x * plan.tile_w), np.uint8)
        got = _kernel(ext, *args)
        assert got.shape == (3, plan.num_tiles, 256)
        for i in range(3):
            assert np.array_equal(got[i], _golden_tile_hists(ext[i], *args))

    @pytest.mark.parametrize("th,tw", [
        (1, 1), (5, 37), (16, 255), (17, 256), (33, 257), (15, 513),
        (31, 300),
    ])
    def test_uneven_blocks(self, rng, th, tw):
        """Tile sides off the 16-row block and 256-pixel segment."""
        ext = rng.integers(0, 256, (2 * th, 3 * tw), np.uint8)
        assert np.array_equal(_kernel(ext, 2, 3, th, tw),
                              _golden_tile_hists(ext, 2, 3, th, tw))

    def test_pixels_past_the_grid_ignored(self, rng):
        ext = rng.integers(0, 256, (40, 70), np.uint8)
        got = _kernel(ext, 2, 2, 16, 32)
        assert np.array_equal(got, _golden_tile_hists(ext, 2, 2, 16, 32))
        assert (got.sum(axis=1) == 16 * 32).all()

    def test_one_tile_whole_frame(self, rng):
        y = rng.integers(0, 256, (67, 301), np.uint8)
        assert np.array_equal(_kernel(y, 1, 1, 67, 301)[0],
                              golden.hist256(y))

    def test_4k_single_tile_one_bin(self):
        """A 1x1 grid at 4K tile size: 8.3M counts in one bin stay exact
        (f32 accumulation is exact below 2^24)."""
        y = np.full((2160, 3840), 200, np.uint8)
        h = _kernel(y, 1, 1, 2160, 3840)[0]
        assert h[200] == 2160 * 3840 and h.sum() == h[200]

    def test_4k_tile_of_an_8x8_grid(self, rng):
        y = rng.integers(0, 256, (270, 480), np.uint8)
        assert np.array_equal(_kernel(y, 1, 1, 270, 480)[0],
                              golden.hist256(y))

    def test_all_values(self):
        y = np.arange(256 * 40, dtype=np.int64).astype(np.uint8).reshape(40,
                                                                          256)
        assert (_kernel(y, 1, 1, 40, 256)[0] == 40).all()


class TestLowersForCuda:
    """The Triton lowering runs without a card: it catches what the GPU
    route refuses (block shapes, unsupported primitives) before a chip
    run."""

    @pytest.mark.parametrize("n,h,w,ty,tx", [
        (4, 1080, 1920, 8, 8), (4, 2160, 3840, 8, 8),
        (4, 1080, 1920, 1, 1), (4, 2160, 3840, 1, 1), (1, 1080, 1920, 8, 8),
    ])
    def test_lowers(self, n, h, w, ty, tx):
        f = jax.jit(lambda x: radix_hist.tile_histograms(
            x, ty, tx, h // ty, w // tx))
        low = f.trace(jax.ShapeDtypeStruct((n, h, w), jnp.uint8)).lower(
            lowering_platforms=("cuda",))
        txt = low.as_text()
        assert "xla.gpu.triton" in txt and "radix_tile_hist" in txt


class TestPathChoice:
    """One device path per platform: the kernel where JAX runs on the
    GPU, XLA formulations elsewhere."""

    @pytest.fixture
    def calls(self, monkeypatch):
        seen = []

        def fake(ext, ty, tx, th, tw, interpret=False):
            seen.append((ext.shape, ty, tx, th, tw))
            n = ty * tx
            return jnp.zeros(ext.shape[:-2] + (n, 256), jnp.int32)

        monkeypatch.setattr(radix_hist, "tile_histograms", fake)
        return seen

    @pytest.mark.parametrize("backend,kernel", [
        ("gpu", True), ("cpu", False)])
    def test_uses_hist_kernel(self, monkeypatch, backend, kernel):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert hops.uses_hist_kernel() is kernel

    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    def test_tile_histograms_route(self, monkeypatch, calls, rng, backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        ext = rng.integers(0, 256, (32, 64), np.uint8)
        out = np.asarray(hops.tile_histograms(jnp.asarray(ext), 2, 2, 16, 32))
        assert out.shape == (4, 256)
        assert calls == ([((32, 64), 2, 2, 16, 32)] if backend == "gpu"
                         else [])
        if backend == "cpu":
            assert np.array_equal(out, _golden_tile_hists(ext, 2, 2, 16, 32))

    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    def test_hist256_route(self, monkeypatch, calls, rng, backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        y = rng.integers(0, 256, (24, 40), np.uint8)
        out = np.asarray(hops.hist256(jnp.asarray(y)))
        assert out.shape == (256,)
        assert calls == ([((24, 40), 1, 1, 24, 40)] if backend == "gpu"
                         else [])

    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    def test_unknown_method_rejected(self, monkeypatch, calls, backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        y = jnp.zeros((8, 8), jnp.uint8)
        with pytest.raises(ValueError, match="unknown histogram method"):
            hops.hist256(y, "bogus")
        with pytest.raises(ValueError, match="unknown histogram method"):
            hops.tile_histograms(y, 1, 1, 8, 8, "bogus")

    def test_clahe_on_gpu_takes_the_kernel(self, monkeypatch, calls, rng):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        y = rng.integers(0, 256, (2, 64, 96), np.uint8)
        plan = cops.make_clahe_plan(64, 96, 2.0, (4, 2))
        cops.clahe_apply(jnp.asarray(y), plan)
        assert calls == [((64, 96), 2, 4, 32, 24)]


class TestPlainStages:
    """The XLA LUT build and interpolation that replaced the TPU kernels,
    against the golden model's own stages."""

    @pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
    def test_lut_build_exact(self, rng, h, w, clip, grid):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        plan = cops.make_clahe_plan(h, w, clip, grid)
        hists = cops._tile_histograms(jnp.asarray(y), plan, "onehot")
        luts = np.asarray(cops._luts_from_hists(hists, plan))
        gl, th, tw = golden.clahe_luts(y, clip, grid)
        assert (th, tw) == (plan.tile_h, plan.tile_w)
        assert np.array_equal(luts.reshape(gl.shape), gl)

    @pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
    def test_interpolation(self, rng, h, w, clip, grid):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        gl, th, tw = golden.clahe_luts(y, clip, grid)
        plan = cops.make_clahe_plan(h, w, clip, grid)
        out = np.asarray(cops._interpolate(
            jnp.asarray(y), jnp.asarray(gl.reshape(-1, 256)), plan))
        assert_clahe_close(out, golden.clahe_apply_luts(y, gl, th, tw))

    @pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
    def test_kernel_histograms_drive_clahe(self, rng, h, w, clip, grid):
        """The whole CLAHE with the kernel's histograms equals the CPU
        path's output exactly."""
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        plan = cops.make_clahe_plan(h, w, clip, grid)
        ext = cops._extend(jnp.asarray(y), plan)
        hists = radix_hist.tile_histograms(
            ext, plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w,
            interpret=True)
        out = cops._interpolate(jnp.asarray(y),
                                cops._luts_from_hists(hists, plan), plan)
        assert np.array_equal(np.asarray(out),
                              np.asarray(cops.clahe_apply(y, plan)))
