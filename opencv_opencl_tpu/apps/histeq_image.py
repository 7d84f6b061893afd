"""Single-frame histogram-equalization tool (<- reference ``singlecolor.cpp``).

Usage: python -m opencv_opencl_tpu.apps.histeq_image <input.jpg> <output.jpg>

Flow and printout mirror the reference (``singlecolor.cpp:15-110``):
load -> BGR2YUV -> split -> equalizeHist(Y) on the device -> merge ->
YUV2BGR -> save, with the per-stage microsecond breakdown and "potential FPS".
"""

from __future__ import annotations

import sys
import time


def run(argv: list[str]) -> int:
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <input.jpg> <output.jpg>")
        print(f"Example: {sys.argv[0]} input.jpg output_enhanced.jpg")
        return -1
    input_file, output_file = argv

    import cv2
    import numpy as np

    import jax.numpy as jnp
    from opencv_opencl_tpu.ops import color as jcolor
    from opencv_opencl_tpu.ops import histeq

    t_start = time.perf_counter()
    bgr = cv2.imread(input_file, cv2.IMREAD_COLOR)
    if bgr is None:
        print(f"Error: Could not load image {input_file}", file=sys.stderr)
        return -1
    print(f"Loaded image: {bgr.shape[1]}x{bgr.shape[0]}")
    t_load = time.perf_counter()

    dev_bgr = jnp.asarray(bgr)
    yuv = jcolor.bgr2yuv(dev_bgr)
    yuv.block_until_ready()
    t_yuv = time.perf_counter()

    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    print(f"Y channel size: {y.shape[1]}x{y.shape[0]}")
    t_split = time.perf_counter()

    y_eq = histeq.equalize_hist(y)
    y_eq.block_until_ready()
    t_eq = time.perf_counter()

    merged = jnp.stack([y_eq, u, v], axis=-1)
    merged.block_until_ready()
    t_merge = time.perf_counter()

    out_bgr = jcolor.yuv2bgr(merged)
    out_np = np.asarray(out_bgr)
    t_bgr = time.perf_counter()

    if not cv2.imwrite(output_file, out_np):
        print(f"Error: Could not save image to {output_file}", file=sys.stderr)
        return -1
    print(f"Enhanced image saved to: {output_file}")
    t_save = time.perf_counter()

    us = lambda a, b: (b - a) * 1e6
    load_us = us(t_start, t_load)
    yuv_us = us(t_load, t_yuv)
    split_us = us(t_yuv, t_split)
    eq_us = us(t_split, t_eq)
    merge_us = us(t_eq, t_merge)
    bgr_us = us(t_merge, t_bgr)
    save_us = us(t_bgr, t_save)
    total_us = us(t_start, t_save)

    print("\n=== PERFORMANCE BREAKDOWN ===")
    print(f"Image loading:        {load_us:.0f} μs")
    print(f"BGR->YUV conversion:  {yuv_us:.0f} μs")
    print(f"Channel splitting:    {split_us:.0f} μs")
    print(f"Histogram equalize:   {eq_us:.0f} μs")
    print(f"Channel merging:      {merge_us:.0f} μs")
    print(f"YUV->BGR conversion:  {bgr_us:.0f} μs")
    print(f"Image saving:         {save_us:.0f} μs")
    print(f"TOTAL PROCESSING:     {total_us:.0f} μs ({total_us / 1000.0:.3f} ms)")

    processing_us = eq_us + merge_us + yuv_us + split_us + bgr_us
    if processing_us > 0:
        print(f"Core processing time: {processing_us:.0f} μs")
        print(f"Potential FPS:        {1e6 / processing_us:.4f} fps")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
