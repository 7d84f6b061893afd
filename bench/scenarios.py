"""The BASELINE.md benchmark configs as one scripted run.

Usage: python -m bench.scenarios [--quick]

1. Global equalizeHist, 1080p (hun.png), parity vs cv2.equalizeHist
2. CLAHE (8x8, clip 2.0), 1080p, parity vs cv2.createCLAHE
3. NV12 Y-channel equalizeHist, 1080p stream, chroma passthrough
4. Batched CLAHE at 3840x2160 (device-resident sustained rate)
5. End-to-end sender loop: NV12 CLAHE -> YUV->RGB decode feed
6. Multi-stream serving: 8x 1080p streams in one dispatch (StreamMux shape)

Run on a GPU (it refuses the CPU).  Each time is the median of device
steps ended by ``block_until_ready``.
"""

from __future__ import annotations

import sys
import time


def _step_ms(fn, x, n=50):
    """Median device ms per call of ``fn(x)``, each ended by
    ``block_until_ready``."""
    import jax

    run = jax.jit(fn)
    jax.block_until_ready(run(x))
    samples = []
    for _i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x))
        samples.append((time.perf_counter() - t0) * 1e3)
    return sorted(samples)[n // 2]


def main() -> None:
    quick = "--quick" in sys.argv
    import cv2
    import numpy as np

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.scenarios: no GPU (JAX backend is "
                 f"{jax.default_backend()!r})")
    import jax.numpy as jnp
    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.models.enhancer import EnhancerConfig, build_enhance_fn
    from opencv_opencl_tpu.ops import histeq
    from opencv_opencl_tpu.ops.clahe import clahe_apply, make_clahe_plan
    from opencv_opencl_tpu.ops import color as jcolor
    from opencv_opencl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    img = cv2.imread("/root/reference/hun.png")
    if img is None:
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    img = img[: img.shape[0] - img.shape[0] % 2, : img.shape[1] - img.shape[1] % 2]
    h, w = img.shape[:2]
    y = cv2.cvtColor(img, cv2.COLOR_BGR2YUV)[..., 0].copy()
    yd = jnp.asarray(y)
    results = []

    # 1. histeq parity + latency
    out = np.asarray(histeq.equalize_hist(yd))
    d1 = int(np.abs(out.astype(int) - cv2.equalizeHist(y).astype(int)).max())
    ms1 = _step_ms(histeq.equalize_hist, yd)
    results.append(("1. equalizeHist 1080p", f"{ms1:.2f} ms", f"max diff {d1} LSB"))

    # 2. CLAHE parity + latency
    plan = make_clahe_plan(h, w, 2.0, (8, 8))
    fn2 = lambda x: clahe_apply(x, plan)
    out = np.asarray(fn2(yd))
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(y)
    d2 = int(np.abs(out.astype(int) - ref.astype(int)).max())
    ms2 = _step_ms(fn2, yd)
    results.append(("2. CLAHE 2.0/8x8 1080p", f"{ms2:.2f} ms", f"max diff {d2} LSB"))

    # 3. NV12 histeq stream step (1080p, chroma passthrough)
    spec3 = FrameSpec(width=w, height=h, fps=30)
    step3 = build_enhance_fn(
        EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH), spec3
    )
    nv12 = jnp.asarray(
        np.random.default_rng(1).integers(
            0, 256, (1, spec3.buffer_rows, w), dtype=np.uint8
        )
    )
    ms3 = _step_ms(step3, nv12)
    results.append(
        ("3. NV12 histeq 1080p step", f"{ms3:.2f} ms",
         f"{1000 / ms3:.0f} fps")
    )

    # 4. batched 4K CLAHE
    if not quick:
        spec4 = FrameSpec(width=3840, height=2160, fps=60)
        step4 = build_enhance_fn(
            EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                           chroma=ChromaPolicy.PASSTHROUGH), spec4
        )
        batch4 = jnp.asarray(
            np.random.default_rng(2).integers(
                0, 256, (4, spec4.buffer_rows, 3840), dtype=np.uint8
            )
        )
        ms4 = _step_ms(step4, batch4, n=24)
        results.append(
            ("4. NV12 CLAHE 4K batch=4", f"{ms4:.2f} ms/step",
             f"{4000 / ms4:.0f} fps")
        )

        # 5. end-to-end sender step: CLAHE + NV12->BGR decode feed
        def sender_step(nv12b):
            enhanced = step4(nv12b)
            bgr = jcolor.nv12_to_bgr(enhanced)
            # keep chain type stable: re-encode luminance-ish back to NV12 in
            # uint8 (the encode feed boundary)
            return jnp.concatenate(
                [bgr[..., 0], enhanced[:, 2160:, :]], axis=1
            )

        ms5 = _step_ms(sender_step, batch4, n=24)
        results.append(
            ("5. sender loop 4K batch=4", f"{ms5:.2f} ms/step",
             f"{4000 / ms5:.0f} fps")
        )

        # 6. multi-stream serving: 8 independent 1080p streams share one
        # dispatch (the StreamMux batch shape; runtime/mux.py) — the
        # serving headline is streams-at-30fps per device
        spec8 = FrameSpec(width=1920, height=1080, fps=30)
        step8 = build_enhance_fn(
            EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                           chroma=ChromaPolicy.PASSTHROUGH), spec8
        )
        batch8 = jnp.asarray(
            np.random.default_rng(3).integers(
                0, 256, (8, spec8.buffer_rows, 1920), dtype=np.uint8
            )
        )
        ms6 = _step_ms(step8, batch8, n=24)
        agg = 8000 / ms6
        results.append(
            ("6. serving 8x1080p streams", f"{ms6:.2f} ms/step",
             # floor, not round: N streams@30 must actually be servable
             f"{agg:.0f} fps aggregate = {int(agg // 30)} streams@30")
        )

        # 7. fused enhance + H.264 GOP encode device step (1080p P
        # frame with full-pel search=8): the device side of the
        # complete encoder — enhancement, motion search+MC, transforms,
        # quantization, reconstruction — as one program
        # (models/fused_encode.py; host entropy excluded)
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn)
        from opencv_opencl_tpu.ops.h264_levels import (
            encode_levels_recon_jit)

        spec7 = FrameSpec(width=1920, height=1080, fps=30)
        gop_fn = build_enhance_gop_fn(
            EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                           chroma=ChromaPolicy.PASSTHROUGH),
            spec7, gop=30, search=8)
        rng7 = np.random.default_rng(7)
        f0 = rng7.integers(0, 256, (spec7.buffer_rows, 1920), np.uint8)
        uv0 = f0[1080:].reshape(540, 960, 2)  # pad to 544 below
        _, ry0, rcb0, rcr0, _ = encode_levels_recon_jit(
            jnp.asarray(np.pad(f0[:1080], ((0, 8), (0, 0)),
                               mode="edge")),
            jnp.asarray(np.pad(uv0[:, :, 0], ((0, 4), (0, 0)),
                               mode="edge")),
            jnp.asarray(np.pad(uv0[:, :, 1], ((0, 4), (0, 0)),
                               mode="edge")),
            jnp.int32(30))

        def enc_step(nv12b):
            # idx0=1: always the P branch (search + MC + residual
            # path); donation is ignored inside the outer jit
            packed, *_ = gop_fn(nv12b, jnp.int32(30), jnp.int32(1),
                                ry0, rcb0, rcr0)
            bump = (jnp.sum(packed.astype(jnp.int32)) & 1
                    ).astype(jnp.uint8)
            return nv12b + bump

        nv7 = jnp.asarray(rng7.integers(
            0, 256, (1, spec7.buffer_rows, 1920), np.uint8))
        ms7 = _step_ms(enc_step, nv7, n=24)
        results.append(
            ("7. fused CLAHE+encode 1080p", f"{ms7:.2f} ms per frame",
             f"{1000 / ms7:.0f} fps device side (search=8)"))

    print(f"\n{'scenario':<28} {'latency':<16} note")
    for name, lat, note in results:
        print(f"{name:<28} {lat:<16} {note}")


if __name__ == "__main__":
    main()
