"""Accelerator-vs-OpenCV parity + timing bench (<- reference ``1frameMeasure.cpp``).

Usage:
  python -m opencv_opencl_tpu.apps.parity_bench --input=hun.png \\
      [--op=histeq|clahe] [--clipLimit=2.0] [--tile=8] [--threshold=1] \\
      [--dump-images] [--repeat=64]

Reproduces the reference harness exactly (``1frameMeasure.cpp``): same Y
plane through the CPU OpenCV implementation and the device kernel, both timed;
``absdiff`` + an analyzeDiff-style check (pixels exceeding ``threshold``,
default +/-1 LSB, must be 0%%); optional debug image dumps
(input_y / out_ocv_y / out_tpu_y / out_diff_y).
"""

from __future__ import annotations

import sys
import time

from opencv_opencl_tpu.apps._cli import parse_kv_args


def analyze_diff(diff, threshold: int) -> float:
    """xf::cv::analyzeDiff equivalent: % of pixels with |diff| > threshold."""
    return float((diff > threshold).mean() * 100.0)


def run(argv: list[str]) -> int:
    opts, pos = parse_kv_args(
        argv,
        {
            "input": str, "op": str, "clipLimit": float, "tile": int,
            "threshold": int, "dump-images": bool, "repeat": int,
        },
    )
    input_path = opts.get("input", pos[0] if pos else "")
    op = opts.get("op", "histeq")
    clip_limit = opts.get("clipLimit", 2.0)
    tile = opts.get("tile", 8)
    threshold = opts.get("threshold", 1)
    repeat = max(opts.get("repeat", 256), 1)

    if not input_path:
        print(f"Usage: {sys.argv[0]} --input=<image> [--op=histeq|clahe] ...",
              file=sys.stderr)
        return -1

    import cv2
    import numpy as np

    import jax.numpy as jnp
    from opencv_opencl_tpu.ops import histeq
    from opencv_opencl_tpu.ops.clahe import _jitted_apply

    bgr = cv2.imread(input_path, cv2.IMREAD_COLOR)
    if bgr is None:
        print("Cannot open image", file=sys.stderr)
        return -1
    # I420 requires even dimensions; crop like GStreamer caps negotiation would
    bgr = bgr[: bgr.shape[0] - bgr.shape[0] % 2, : bgr.shape[1] - bgr.shape[1] % 2]
    height, width = bgr.shape[:2]
    print(f"Input image height : {height}")
    print(f"Input image width  : {width}")

    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
    y_plane = yuv[:height].copy()

    # -------------------- OpenCV software --------------------
    if op == "histeq":
        cv_fn = lambda: cv2.equalizeHist(y_plane)
    elif op == "clahe":
        c = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(tile, tile))
        cv_fn = lambda: c.apply(y_plane)
    else:
        print(f"unknown --op: {op}", file=sys.stderr)
        return -1
    t1 = time.perf_counter()
    y_ocv = cv_fn()
    t2 = time.perf_counter()
    print(f"OpenCV {op} time: {(t2 - t1) * 1e3:.3f} ms")

    # -------------------- device kernel --------------------
    if op == "histeq":
        tpu_fn = lambda yd: histeq.equalize_hist(yd)
    else:
        tpu_fn = _jitted_apply(
            height, width, float(clip_limit), (tile, tile), "onehot"
        )
    import jax

    y_dev = jnp.asarray(y_plane)
    y_tpu_dev = tpu_fn(y_dev)  # compile (the xclbin-load analogue)
    y_tpu_dev.block_until_ready()

    samples = []
    for _i in range(repeat):
        t3 = time.perf_counter()
        jax.block_until_ready(tpu_fn(y_dev))
        samples.append((time.perf_counter() - t3) * 1e3)
    tpu_ms = sorted(samples)[repeat // 2]
    print(f"device {op} time: {tpu_ms:.3f} ms  "
          f"(median of {repeat}, each ended by block_until_ready)")
    y_tpu = np.asarray(y_tpu_dev)

    # -------------------- Compare results --------------------
    diff = cv2.absdiff(y_ocv, y_tpu)
    err_per = analyze_diff(diff, threshold)
    if err_per > 0.0:
        print(f"ERROR: Results mismatch, error = {err_per}%", file=sys.stderr)
        rc = 1
    else:
        print("Results match!")
        rc = 0
    print(f"Max absolute difference: {int(diff.max())} LSB")

    if opts.get("dump-images"):
        cv2.imwrite("input_y.jpg", y_plane)
        cv2.imwrite("out_ocv_y.jpg", y_ocv)
        cv2.imwrite("out_tpu_y.jpg", y_tpu)
        cv2.imwrite("out_diff_y.jpg", diff)
        print("Saved: input_y.jpg out_ocv_y.jpg out_tpu_y.jpg out_diff_y.jpg")
    return rc


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
