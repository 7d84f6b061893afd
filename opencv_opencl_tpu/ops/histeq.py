"""Global histogram equalization as jitted JAX ops (single frame + batched).

The device replacement for the reference's compute core: ``cv::equalizeHist``
on the worker thread (``OpenCVequalHist.cpp:145``) and the FPGA kernel
``equalizeHist_accel`` (``accel.cpp:36-61``).  Like the FPGA kernel, the op
is *two-input*: the histogram/CDF may come from a separate reference frame
(the host passes the same frame twice in the reference,
``OpenCLequalHist.cpp:356-357``); ``equalize_hist_ref`` exposes that hook,
which also enables previous-frame-CDF latency hiding in streaming mode.

Batched variants treat the frame batch as the "data parallel" axis — the
device analogue of the reference's worker-thread pool over a frame queue
(``OpenCVequalHist.cpp:396-402``): instead of 1-8 CPU workers, one device
maps the whole batch at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opencv_opencl_tpu.ops.histogram import equalize_lut, hist256

__all__ = [
    "equalize_hist",
    "equalize_hist_ref",
    "equalize_hist_batch",
    "apply_lut",
]


def apply_lut(y: jax.Array, lut: jax.Array) -> jax.Array:
    """Map a uint8 image through a 256-entry uint8 LUT."""
    return jnp.take(lut, y.astype(jnp.int32), axis=0)


@functools.partial(jax.jit, static_argnames=("method",))
def equalize_hist(y: jax.Array, method: str = "onehot") -> jax.Array:
    """OpenCV-exact global equalization of one uint8 Y plane."""
    lut = equalize_lut(hist256(y, method), total=y.size)
    return apply_lut(y, lut)


@functools.partial(jax.jit, static_argnames=("method",))
def equalize_hist_ref(y: jax.Array, ref: jax.Array, method: str = "onehot") -> jax.Array:
    """Two-input form: histogram from ``ref``, mapping applied to ``y``
    (the accel.cpp:36-40 signature)."""
    lut = equalize_lut(hist256(ref, method), total=ref.size)
    return apply_lut(y, lut)


@functools.partial(jax.jit, static_argnames=("method",))
def equalize_hist_batch(y: jax.Array, method: str = "onehot") -> jax.Array:
    """Per-frame equalization of a uint8 batch (N, H, W)."""
    total = y.shape[-2] * y.shape[-1]

    def one(frame):
        lut = equalize_lut(hist256(frame, method), total=total)
        return apply_lut(frame, lut)

    return jax.vmap(one)(y)
