"""opencv_opencl_tpu — a JAX/XLA/Pallas video-enhancement framework.

A ground-up rebuild of the capabilities of the reference MPSoC project
``kimkimhun3/OpenCV-OpenCL`` (real-time histogram equalization and CLAHE on
the Y plane of NV12 video, 1080p/4K @ 30/60 FPS, with streaming relays and a
WebRTC sender), designed accelerator-first:

- the OpenCV CPU / OpenCL-FPGA compute paths (reference ``accel.cpp``,
  ``OpenCVequalHist.cpp``, ``CLAHECompare.cpp``) become batched, jitted
  JAX ops and fused Pallas kernels over frames resident in device memory;
- the ARM<->FPGA DMA transfer path (``OpenCLequalHist.cpp:346-365``) becomes
  a host->device double-buffered frame feeder with an out-of-order resequencer
  (``runtime/``);
- the measurement harnesses (``1frameMeasure.cpp``, ``clahevideo.cpp``) are
  reproduced so every kernel is bit-compared against ``cv2.equalizeHist`` /
  ``cv2.createCLAHE`` (``metrics/``, ``tests/``);
- the GStreamer/RTP/WebRTC I/O shell is retained behind the frame-in /
  frame-out boundary (``io/``), exactly at the reference's worker interface.

Subpackages
-----------
core      frame layouts (NV12/I420/YUV), OpenCV-exact color conversion,
          numpy golden models (the parity oracles)
ops       jitted JAX ops + a Pallas GPU kernel (histogram, equalizeHist, CLAHE)
runtime   frame feeder, leaky queues, resequencer, processing engine
parallel  device-mesh sharding (frame-batch DP + spatial sharding)
metrics   streaming counters, status classifier, timing decomposition
models    the configurable "enhancer" pipeline (the flagship model)
apps      CLI programs mirroring the reference binaries 1:1
io        video file / GStreamer / RTP / WebRTC-signaling shells
utils     misc helpers (image I/O, env info)
"""

from opencv_opencl_tpu.version import __version__

__all__ = ["__version__"]
