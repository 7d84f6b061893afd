"""Method-comparison micro-bench (<- reference ``m2.cpp``).

Usage: python -m opencv_opencl_tpu.apps.m2_bench <input.jpg> <output.jpg>

The reference compared split/merge vs zero-copy Mat views to justify the
zero-copy worker design (``m2.cpp:42-85``, rationale for
``nextimprovement.cpp``).  The device analogue of that choice: METHOD 1 runs
each stage as a separate dispatch (split -> equalize -> merge, device
round-trips between), METHOD 2 fuses the whole YUV pipeline into one jitted
XLA program (the framework's actual design).  Printout format mirrors the
reference.
"""

from __future__ import annotations

import sys
import time


def run(argv: list[str]) -> int:
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <input.jpg> <output.jpg>")
        return -1
    input_file, output_file = argv

    import cv2
    import numpy as np

    import jax
    import jax.numpy as jnp
    from opencv_opencl_tpu.ops import color as jcolor
    from opencv_opencl_tpu.ops import histeq

    t_start = time.perf_counter()
    bgr = cv2.imread(input_file, cv2.IMREAD_COLOR)
    if bgr is None:
        print(f"Error: Could not load image {input_file}", file=sys.stderr)
        return -1
    print(f"Processing image: {bgr.shape[1]}x{bgr.shape[0]}")

    dev = jnp.asarray(bgr)
    yuv = jcolor.bgr2yuv(dev)
    yuv.block_until_ready()
    t_convert = time.perf_counter()

    # METHOD 1: staged dispatches (split -> equalize -> merge)
    print("\n=== METHOD 1: staged dispatches (split/merge) ===")
    m1_start = time.perf_counter()
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    y.block_until_ready()
    y_eq = histeq.equalize_hist(y)
    y_eq.block_until_ready()
    merged = jnp.stack([y_eq, u, v], axis=-1)
    merged.block_until_ready()
    m1_us = (time.perf_counter() - m1_start) * 1e6

    # METHOD 2: one fused jitted program (the framework's design)
    print("\n=== METHOD 2: fused single-dispatch pipeline ===")

    @jax.jit
    def fused(yuv):
        y_eq = histeq.equalize_hist(yuv[..., 0])  # nested jit inlines
        return jnp.stack([y_eq, yuv[..., 1], yuv[..., 2]], axis=-1)

    fused(yuv).block_until_ready()  # compile
    m2_start = time.perf_counter()
    out2 = fused(yuv)
    out2.block_until_ready()
    m2_us = (time.perf_counter() - m2_start) * 1e6

    result = np.asarray(jcolor.yuv2bgr(merged))
    save_start = time.perf_counter()
    ok = cv2.imwrite(output_file, result)
    save_us = (time.perf_counter() - save_start) * 1e6
    if not ok:
        print("Error: Could not save image", file=sys.stderr)
        return -1
    print(f"\nEnhanced image saved to: {output_file}")

    convert_us = (t_convert - t_start) * 1e6
    total_us = (time.perf_counter() - t_start) * 1e6
    print("\n=== PERFORMANCE COMPARISON ===")
    print(f"Image loading + BGR->YUV:  {convert_us:.0f} μs")
    print(f"Method 1 (split/merge):    {m1_us:.0f} μs")
    print(f"Method 2 (fused jit):      {m2_us:.0f} μs")
    print(f"Saving result:             {save_us:.0f} μs")
    print(f"Total time:                {total_us:.0f} μs")
    print("\nPotential FPS (processing only):")
    print(f"Method 1: {1e6 / m1_us if m1_us > 0 else 0:.4f} fps")
    print(f"Method 2: {1e6 / m2_us if m2_us > 0 else 0:.4f} fps")
    if m1_us > 0 and m2_us > 0:
        print(f"Method 2 speedup: {m1_us / m2_us:.4f}x faster")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
