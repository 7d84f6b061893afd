"""Tests of code that runs only on the card: the radix histogram kernel
compiled through Triton, and the enhancement paths that call it.

They skip without a GPU; ``python chip_smoke.py`` runs them on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.ops import clahe as cops
from opencv_opencl_tpu.ops import histeq
from opencv_opencl_tpu.ops import histogram as hops
from opencv_opencl_tpu.ops.pallas import radix_hist

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n,h,w,ty,tx", [
    (1, 97, 131, 3, 5), (2, 1080, 1920, 8, 8), (2, 270, 480, 1, 1),
    (1, 64, 4096, 1, 1),
])
def test_kernel_compiled_exact(gpu, rng, n, h, w, ty, tx):
    th, tw = h // ty, w // tx
    x = rng.integers(0, 256, (n, h, w), np.uint8)
    got = np.asarray(radix_hist.tile_histograms(jnp.asarray(x), ty, tx,
                                                th, tw))
    for i in range(n):
        ref = np.stack([golden.hist256(np.ascontiguousarray(
            x[i, a * th:(a + 1) * th, b * tw:(b + 1) * tw]))
            for a in range(ty) for b in range(tx)])
        assert np.array_equal(got[i], ref)


def test_gpu_takes_the_kernel(gpu):
    assert hops.uses_hist_kernel()


@pytest.mark.parametrize("h,w,grid", [(97, 131, (8, 8)), (1080, 1920, (8, 8))])
def test_clahe_on_card(gpu, rng, h, w, grid):
    y = rng.integers(0, 256, (h, w), np.uint8)
    out = np.asarray(cops.clahe(jnp.asarray(y), 2.0, grid))
    d = np.abs(out.astype(int) - golden.clahe(y, 2.0, grid).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_equalize_on_card(gpu, rng):
    y = rng.integers(0, 256, (3, 1080, 1920), np.uint8)
    out = np.asarray(histeq.equalize_hist_batch(jnp.asarray(y)))
    for i in range(3):
        assert np.array_equal(out[i], golden.equalize_hist(y[i]))
