"""Multi-chip sharding on the 8-device virtual CPU mesh.

Validates that the sharded (data x space) pipeline is bit-identical to the
single-device ops — sharding must never change numerics.
"""

import cv2
import numpy as np
import pytest

from opencv_opencl_tpu.core.frames import ChromaPolicy
from opencv_opencl_tpu.models.enhancer import EnhancerConfig
from opencv_opencl_tpu.ops import clahe as clahe_ops
from tests.conftest import assert_clahe_close
from opencv_opencl_tpu.parallel import (
    best_mesh_shape,
    build_sharded_pipeline,
    make_mesh,
    sharded_clahe,
    sharded_histeq,
)


def test_best_mesh_shape():
    assert best_mesh_shape(8) == (4, 2)
    assert best_mesh_shape(4) == (2, 2)
    assert best_mesh_shape(2) == (2, 1)
    assert best_mesh_shape(1) == (1, 1)
    assert best_mesh_shape(6) == (3, 2)


def test_make_mesh_8():
    mesh = make_mesh(8)
    assert mesh.shape == {"data": 4, "space": 2}


def test_sharded_histeq_matches_cv2(rng):
    mesh = make_mesh(8)  # data=4, space=2
    batch = rng.integers(0, 256, (4, 64, 128), dtype=np.uint8)
    fn = sharded_histeq(mesh, 64, 128)
    out = np.asarray(fn(batch))
    for i in range(4):
        assert np.array_equal(out[i], cv2.equalizeHist(batch[i]))


def test_sharded_clahe_matches_cv2(rng):
    mesh = make_mesh(8)
    batch = rng.integers(0, 256, (4, 64, 128), dtype=np.uint8)
    plan = clahe_ops.make_clahe_plan(64, 128, 2.0, (8, 8))
    fn = sharded_clahe(mesh, plan)
    out = np.asarray(fn(batch))
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for i in range(4):
        assert_clahe_close(out[i], c.apply(batch[i]))


def test_sharded_clahe_space4(rng):
    mesh = make_mesh(8, shape=(2, 4))
    batch = rng.integers(0, 256, (2, 64, 128), dtype=np.uint8)
    plan = clahe_ops.make_clahe_plan(64, 128, 2.0, (8, 8))
    out = np.asarray(sharded_clahe(mesh, plan)(batch))
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for i in range(2):
        assert_clahe_close(out[i], c.apply(batch[i]))


@pytest.mark.parametrize("h,w,grid,shape", [
    (63, 127, (8, 8), (4, 2)),    # reflect-padded tiles
    (97, 131, (8, 8), (2, 4)),    # odd geometry, space=4
    (64, 128, (8, 8), (2, 3)),    # tiles_y=8 NOT divisible by space=3
    (67, 131, (5, 3), (2, 3)),    # odd grid AND odd mesh
])
def test_sharded_clahe_arbitrary_geometry(rng, h, w, grid, shape):
    """Round-2 generalization: any frame size / tile grid / mesh works
    (round 1 raised on non-tile-divisible or tiles_y % space != 0)."""
    mesh = make_mesh(shape[0] * shape[1], shape=shape)
    batch = rng.integers(0, 256, (shape[0], h, w), dtype=np.uint8)
    plan = clahe_ops.make_clahe_plan(h, w, 2.0, grid)
    out = np.asarray(sharded_clahe(mesh, plan)(batch))
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=grid)
    for i in range(batch.shape[0]):
        assert_clahe_close(out[i], c.apply(batch[i]))


def test_sharded_histeq_odd_height(rng):
    mesh = make_mesh(6, shape=(2, 3))  # 63 rows % 3 == 0 but % 8 != 0; try 61
    fn = sharded_histeq(mesh, 61, 127)
    batch = rng.integers(0, 256, (2, 61, 127), dtype=np.uint8)
    out = np.asarray(fn(batch))
    for i in range(2):
        assert np.array_equal(out[i], cv2.equalizeHist(batch[i]))


def test_full_sharded_pipeline_odd_geometry(rng):
    """The flagship 1919x1079-style odd case, scaled down: full NV12 step
    over a mesh whose space axis divides nothing."""
    mesh = make_mesh(6, shape=(2, 3))
    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    h, w = 119, 191
    fn, sharding = build_sharded_pipeline(cfg, h, w, mesh)
    y = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (2, (h + 1) // 2, w), dtype=np.uint8)
    import jax
    y_dev = jax.device_put(y, sharding)
    y_out, uv_out = fn(y_dev, uv)
    y_out = np.asarray(y_out)
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for i in range(2):
        assert_clahe_close(y_out[i], c.apply(y[i]))
    assert np.array_equal(np.asarray(uv_out), uv)


def test_full_sharded_pipeline(rng):
    mesh = make_mesh(8)
    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    fn, sharding = build_sharded_pipeline(cfg, 64, 128, mesh)
    y = rng.integers(0, 256, (4, 64, 128), dtype=np.uint8)
    uv = rng.integers(0, 256, (4, 32, 128), dtype=np.uint8)
    y_out, uv_out = fn(y, uv)
    y_out = np.asarray(y_out)
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for i in range(4):
        assert_clahe_close(y_out[i], c.apply(y[i]))
    assert np.array_equal(np.asarray(uv_out), uv)


def test_full_sharded_pipeline_gray_histeq(rng):
    mesh = make_mesh(4, shape=(2, 2))
    cfg = EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY)
    fn, _ = build_sharded_pipeline(cfg, 64, 128, mesh)
    y = rng.integers(0, 256, (2, 64, 128), dtype=np.uint8)
    uv = rng.integers(0, 256, (2, 32, 128), dtype=np.uint8)
    y_out, uv_out = fn(y, uv)
    for i in range(2):
        assert np.array_equal(np.asarray(y_out)[i], cv2.equalizeHist(y[i]))
    assert (np.asarray(uv_out) == 128).all()


def test_sharded_clahe_pallas_band(rng):
    """The band-interpolation path under shard_map: must match cv2 within
    the CLAHE bar for both space-axis sizes."""
    for shape, nsp in [((2, 2), None), ((2, 4), None)]:
        mesh = make_mesh(shape[0] * shape[1], shape=shape)
        batch = rng.integers(0, 256, (2, 64, 128), dtype=np.uint8)
        plan = clahe_ops.make_clahe_plan(64, 128, 2.0, (8, 8))
        fn = sharded_clahe(mesh, plan)
        out = np.asarray(fn(batch))
        c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        for i in range(2):
            assert_clahe_close(out[i], c.apply(batch[i]))


def test_sharded_enhancer_matches_single_chip(rng):
    """ShardedEnhancer (the relay --mesh path) produces bit-identical NV12
    output to the single-chip Enhancer across mesh shapes."""
    from opencv_opencl_tpu.core.frames import FrameSpec
    from opencv_opencl_tpu.models.enhancer import Enhancer
    from opencv_opencl_tpu.parallel.sharded import ShardedEnhancer

    spec = FrameSpec(width=128, height=64, fps=30)
    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    batch = rng.integers(0, 256, (4, spec.buffer_rows, 128), dtype=np.uint8)
    ref = np.asarray(Enhancer(cfg, spec).process_batch(batch))
    for shape in ((4, 2), (2, 2), (2, 4)):
        se = ShardedEnhancer(cfg, spec, shape=shape)
        out = np.asarray(se.process_batch(batch))
        assert out.shape == batch.shape
        assert np.array_equal(out, ref), f"mesh {shape} diverged"


def test_sharded_enhancer_rejects_bad_batch(rng):
    from opencv_opencl_tpu.core.frames import FrameSpec
    from opencv_opencl_tpu.models.enhancer import EnhancerConfig
    from opencv_opencl_tpu.parallel.sharded import ShardedEnhancer

    spec = FrameSpec(width=128, height=64, fps=30)
    cfg = EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY)
    se = ShardedEnhancer(cfg, spec, shape=(4, 2))
    batch = rng.integers(0, 256, (3, spec.buffer_rows, 128), dtype=np.uint8)
    with pytest.raises(ValueError, match="not divisible"):
        se.process_batch(batch)


def test_relay_mesh_flag(tmp_path):
    """relay --mesh=2x2 runs the full feeder loop over a sharded enhancer
    on the virtual 8-device CPU mesh and writes correct frames."""
    from opencv_opencl_tpu.apps import relay

    out = tmp_path / "out.nv12"
    rc = relay.run([
        "--source=test", "--width=128", "--height=64", "--max-frames=4",
        "--batch=2", "--op=clahe", "--mesh=2x2", f"--sink={out}",
    ])
    assert rc == 0
    data = out.read_bytes()
    frame_bytes = 128 * 96  # 64*3//2 rows
    assert len(data) == 4 * frame_bytes


@pytest.mark.slow
def test_sharded_pipeline_fuzz():
    """Property fuzz of the multi-chip path: random geometry x tile grid
    x mesh shape x op, each vs cv2 (run with -m slow)."""
    r = np.random.default_rng(404)
    import jax

    from opencv_opencl_tpu.core.frames import FrameSpec
    from opencv_opencl_tpu.parallel.sharded import ShardedEnhancer

    shapes = [(4, 2), (2, 2), (2, 4), (8, 1), (1, 8), (2, 3)]
    c_ops = ["clahe", "histeq"]
    for i in range(20):
        h = int(r.integers(16, 220)) * 2  # NV12 needs even dims
        w = int(r.integers(16, 160)) * 2
        grid = (int(r.integers(1, 9)), int(r.integers(1, 9)))
        mesh_shape = shapes[int(r.integers(0, len(shapes)))]
        op = c_ops[int(r.integers(0, 2))]
        spec = FrameSpec(width=w, height=h, fps=30)
        cfg = EnhancerConfig(
            op=op, clip_limit=float(r.choice([0.5, 2.0, 40.0])),
            tile_grid=grid, chroma=ChromaPolicy.PASSTHROUGH)
        n = mesh_shape[0]
        batch = np.asarray(r.integers(
            0, 256, (n, spec.buffer_rows, w), dtype=np.uint8))
        se = ShardedEnhancer(cfg, spec, shape=mesh_shape)
        out = np.asarray(se.process_batch(batch))
        for b in range(n):
            y = batch[b, :h]
            if op == "clahe":
                ref = cv2.createCLAHE(
                    clipLimit=cfg.clip_limit,
                    tileGridSize=grid).apply(y)
                assert_clahe_close(out[b, :h], ref), (h, w, grid,
                                                      mesh_shape, op)
            else:
                ref = cv2.equalizeHist(y)
                assert np.array_equal(out[b, :h], ref), (h, w, grid,
                                                         mesh_shape, op)
            assert np.array_equal(out[b, h:], batch[b, h:])
