"""Test configuration: JAX on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices,
so the sharding logic is exercised without a multi-device machine.  This
must happen before any JAX backend starts.  The one exception is
``python chip_smoke.py`` on a GPU host: it runs the tests marked ``gpu``
inside its own process, after JAX has started on the card, and then this
file leaves the platform as it is.
"""

import os

import jax
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


def assert_clahe_close(out, ref):
    """CLAHE-vs-cv2 assertion: the reference's hard <=1 LSB bar.

    On the CPU test backend LLVM FMA-contracts the bilinear blend,
    flipping rare exact-tie pixels by 1 (the golden model itself is
    0 LSB against cv2).  The fraction limit catches any real
    algorithmic error.
    """
    out = np.asarray(out)
    ref = np.asarray(ref)
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1, f"max diff {d.max()}"
    # ties are denser on tiny frames (coarse LUT steps); a real algorithmic
    # error shows up as diffs > 1 or a large fraction, not scattered 1s
    frac = (d > 0).mean()
    assert frac < 0.01, f"{frac:.2%} pixels off by 1 — more than FMA ties"


@pytest.fixture
def gpu():
    """For tests of code that runs only on the card (the Triton kernel
    compiled, not interpreted).  Decided here, not at import, so every
    test worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: `python chip_smoke.py` runs these on "
                    "the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def hun_y():
    """The reference test asset hun.png (1919x1079) converted to a Y plane,
    as in 1frameMeasure.cpp (BGR2YUV_I420 -> Y). Falls back to a synthetic
    1919x1079 gradient+noise image if the asset is unavailable."""
    import cv2

    path = "/root/reference/hun.png"
    if os.path.exists(path):
        img = cv2.imread(path)
        yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV)
        return yuv[..., 0].copy()
    r = np.random.default_rng(0)
    base = np.linspace(0, 255, 1919, dtype=np.float32)[None, :]
    y = np.clip(base + r.normal(0, 20, (1079, 1919)), 0, 255).astype(np.uint8)
    return y


def sinusoid_pan_frames(w, h, n, step=0.5, seed=0, terms=4):
    """NV12 frames of a smooth band-limited scene (sinusoid mixture)
    translated exactly ``step`` pixels per frame — the shared fixture
    content for sub-pel motion tests (step 0.5 = half-pel motion,
    0.25 = quarter-pel)."""
    rng_ = np.random.default_rng(seed)
    ph = rng_.uniform(0, 6.28, 4)
    out = []
    for i in range(n):
        m = np.arange(h)[:, None] + i * step
        v = np.arange(w)[None, :] + i * step
        y = (128 + 50 * np.sin(2 * np.pi * m / 17.3 + ph[0]) *
             np.cos(2 * np.pi * v / 23.7 + ph[1])
             + 40 * np.sin(2 * np.pi * (m + v) / 31.9 + ph[2]))
        if terms >= 4:
            y = y + 25 * np.cos(2 * np.pi * (2 * m - v) / 27.1 + ph[3])
        uv = np.full((h // 2, w), 128, np.uint8)
        out.append(np.concatenate(
            [np.clip(y, 0, 255).astype(np.uint8), uv], 0))
    return out


def flicker_frames(w, h, n, seed=0):
    """Two alternating random scenes + a small fresh-noise insert per
    frame: the two-frames-back reference predicts far better than the
    previous frame (shared multi-reference test content)."""
    rng_ = np.random.default_rng(seed)
    scenes = [rng_.integers(0, 256, (h * 3 // 2, w), np.uint8)
              for _ in range(2)]
    out = []
    for i in range(n):
        f = scenes[i % 2].copy()
        f[8:16, 8:24] = rng_.integers(0, 256, (8, 16), np.uint8)
        out.append(f)
    return out
