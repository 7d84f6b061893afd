"""Benchmark: the NV12 4K CLAHE enhance step on one GPU.

BASELINE.md: "bit-exact (+/-1 LSB) CLAHE + equalizeHist on NV12 4K frames at
>=60 FPS sustained ..., including host transfer" (the reference ZCU106
design target is 3840x2160@60).

Two numbers: the device step (frames resident on the card, each step
ended by ``block_until_ready``) and the host loop (NV12 in from host
memory, enhanced NV12 back, so PCIe transfers included).

Usage: python bench.py [batch] [steps]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
Fails without a GPU: a CPU timing says nothing about the card.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _median_s(fn, steps: int) -> float:
    ts = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[steps // 2]


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU (JAX backend is "
                 f"{jax.default_backend()!r})")

    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.io.videofile import TestSource
    from opencv_opencl_tpu.models.enhancer import EnhancerConfig, build_enhance_fn
    from opencv_opencl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    width, height = 3840, 2160
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50

    spec = FrameSpec(width=width, height=height, fps=60)
    cfg = EnhancerConfig(
        op="clahe", clip_limit=2.0, tile_grid=(8, 8),
        chroma=ChromaPolicy.PASSTHROUGH,
    )
    step = build_enhance_fn(cfg, spec, donate=False)
    frames = np.stack(list(TestSource(spec, num_frames=batch, seed=0)))
    dev = jax.device_put(frames)

    t0 = time.perf_counter()
    jax.block_until_ready(step(dev))
    compile_s = time.perf_counter() - t0
    device_s = _median_s(lambda: jax.block_until_ready(step(dev)), steps)
    np.asarray(step(frames))
    host_s = _median_s(lambda: np.asarray(step(frames)), max(steps // 5, 3))
    device_fps = batch / device_s
    d0 = jax.devices()[0]

    print(json.dumps({
        "metric": "nv12_4k_clahe_fps",
        "value": round(device_fps, 2),
        "unit": "fps",
        "vs_baseline": round(device_fps / 60.0, 3),
        "detail": {
            "config": "full NV12 step: CLAHE clip=2.0 8x8 on Y + chroma "
                      "passthrough, 3840x2160, uint8",
            "measure": f"median of {steps} device steps of batch {batch}, "
                       "each ended by block_until_ready",
            "per_frame_ms": round(device_s / batch * 1e3, 4),
            "host_loop_fps": round(batch / host_s, 2),
            "compile_s": round(compile_s, 1),
            "platform": d0.platform,
            "device_kind": d0.device_kind,
            "device_count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
