"""Environment/device discovery report.

The device analogue of the reference's accelerator discovery prints
(``xcl::get_xil_devices`` + device name + xclbin load banner,
``OpenCLequalHist.cpp:106-140``): one call that reports what compute is
available and how the framework will use it.
"""

from __future__ import annotations

__all__ = ["env_report", "print_env_report"]


def env_report() -> dict:
    import jax

    import opencv_opencl_tpu
    from opencv_opencl_tpu import native
    from opencv_opencl_tpu.ops.histogram import uses_hist_kernel

    devices = jax.devices()
    report = {
        "framework_version": opencv_opencl_tpu.__version__,
        "jax_version": jax.__version__,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "devices": [str(d) for d in devices],
        "device_count": len(devices),
        "histogram_path": ("radix Pallas kernel (Triton)"
                           if uses_hist_kernel() else "XLA"),
        "native_runtime": native.available(),
    }
    if not native.available():
        report["native_build_error"] = (native.build_error() or "")[:200]
    try:
        import cv2

        report["opencv_oracle"] = cv2.__version__
    except ImportError:
        report["opencv_oracle"] = None
    try:
        import gi  # noqa: F401

        report["gstreamer_python"] = True
    except ImportError:
        report["gstreamer_python"] = False
    return report


def print_env_report() -> None:
    r = env_report()
    print("=== opencv_opencl_tpu environment ===")
    print(f"Framework:        {r['framework_version']} (jax {r['jax_version']})")
    print(f"Compute platform: {r['platform']} {r['device_kind']} "
          f"({r['device_count']} device(s): {', '.join(r['devices'])})")
    print(f"Histograms:       {r['histogram_path']}")
    print(f"Native runtime:   {'available' if r['native_runtime'] else 'unavailable'}")
    print(f"OpenCV oracle:    {r['opencv_oracle'] or 'not installed'}")
    print(f"GStreamer python: {'yes' if r['gstreamer_python'] else 'no (cv2 file I/O fallback)'}")


if __name__ == "__main__":
    print_env_report()
