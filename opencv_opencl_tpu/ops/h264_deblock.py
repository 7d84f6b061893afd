"""Device-side H.264 in-loop deblocking (spec 8.7) — the device recon chain.

The oracle (io/h264_deblock.py) defines correctness; this module makes
the FILTERED reference picture computable on the accelerator so the
device GOP encoder's reconstruction chain never leaves device memory when the
in-loop filter is on.

The spec's per-MB raster ordering is a 2D wavefront: with V(i,j)/H(i,j)
the vertical/horizontal edge filtering of macroblock (i, j),

    full(i,j)  needs  full(i,j-1)   (left MB completely filtered),
                      full(i-1,j)   (top row completely filtered),
                      V(i-1,j+1)    (top-right V writes the top-left
                                     halo this MB's top edges read).

Scheduling macroblock (i, j) at step ``t = 2*i + j`` satisfies every
constraint (left at t-1, top at t-2, top-right at t-1) and runs the
whole picture in ``2*(mb_h-1) + mb_w`` steps with all diagonal MBs
filtered in parallel.  Same-step MBs are (i, j) and (i-k, j+2k): their
20x20 work regions are row-disjoint for k >= 2 and column-disjoint for
k = 1 (32-column offset vs 20-column patches), so the batched scatter
is provably collision-free; spec-order pairs that the schedule reorders
or runs concurrently never share pixels (write reach is 3 samples per
edge side).

Implementation: a ``lax.scan`` over t; each step gathers one 20x20
luma patch (and 10x10 chroma patches) per MB row via advanced
indexing, applies the 4 vertical then 4 horizontal edge filters
(vectorized over the 16 edge rows and vmapped over the diagonal), and
scatters the patches back.  Lanes whose diagonal position falls outside
the picture are redirected to a PER-LANE scratch macroblock column
(padded to the right of the picture) with bS = 0 — identity work, no
write collisions.  Pure XLA (gather/scatter + elementwise).

Bit-exactness vs the oracle is proven in tests/test_h264_deblock_tpu.py
(random pictures + adversarial metadata on the CPU backend), and the
oracle itself is decoder-conformance proven through libavcodec.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opencv_opencl_tpu.io.h264_deblock import ALPHA, BETA, TC0

__all__ = ["deblock_planes", "deblock_planes_jit", "bs_grids"]

_QPC_TAB = np.array(
    list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                       37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    dtype=np.int32)


def bs_grids(intra: jax.Array, nnz4: jax.Array, mv: jax.Array,
             ref: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Boundary strengths on the 4x4 block grid (device twin of the
    oracle's ``_bs_edges``): returns (bs_v, bs_h), each (mb_h*4,
    mb_w*4) int32; entry [b, a] is the edge LEFT of block column a /
    ABOVE block row b.  Column/row 0 (picture boundary) is 0."""
    intra4 = jnp.repeat(jnp.repeat(intra.astype(bool), 4, 0), 4, 1)
    # mv/ref may be per-MB (repeat 4) or quadrant-granular (repeat 2
    # — the partition modes' per-8x8 motion)
    g = 4 if mv.shape[0] == intra.shape[0] else 2
    mv4 = jnp.repeat(jnp.repeat(mv.astype(jnp.int32), g, 0), g, 1)
    ref4 = jnp.repeat(jnp.repeat(ref.astype(jnp.int32), g, 0), g, 1)
    nnz4 = nnz4.astype(bool)
    out = []
    for ax in (1, 0):  # vertical edges compare along columns, H rows
        p_intra = jnp.roll(intra4, 1, axis=ax)
        p_nnz = jnp.roll(nnz4, 1, axis=ax)
        p_mv = jnp.roll(mv4, 1, axis=ax)
        p_ref = jnp.roll(ref4, 1, axis=ax)
        either_intra = p_intra | intra4
        n4 = intra4.shape[ax]
        mb_edge = (jnp.arange(n4) % 4 == 0)
        mb_edge = mb_edge[None, :] if ax == 1 else mb_edge[:, None]
        mv_far = (jnp.abs(p_mv - mv4) >= 4).any(axis=2)
        bs = jnp.where((p_ref != ref4) | mv_far, 1, 0)
        bs = jnp.where(p_nnz | nnz4, 2, bs)
        bs = jnp.where(either_intra, 3, bs)
        bs = jnp.where(either_intra & mb_edge, 4, bs)
        if ax == 1:
            bs = bs.at[:, 0].set(0)
        else:
            bs = bs.at[0, :].set(0)
        out.append(bs.astype(jnp.int32))
    return out[0], out[1]


def _edge_filter(slab: jax.Array, bs: jax.Array, alpha: jax.Array,
                 beta: jax.Array, tc0_vec: jax.Array,
                 chroma: bool) -> jax.Array:
    """Filter one edge.  ``slab`` is (n, 8) int32 [p3..p0 q0..q3] for
    luma or (n, 4) [p1 p0 q0 q1] for chroma; ``bs`` (n,) int32.
    Returns the filtered slab (spec 8.7.2.3/8.7.2.4)."""
    if chroma:
        p1, p0, q0, q1 = (slab[:, 0], slab[:, 1], slab[:, 2],
                          slab[:, 3])
    else:
        p3, p2, p1, p0 = (slab[:, 0], slab[:, 1], slab[:, 2],
                          slab[:, 3])
        q0, q1, q2, q3 = (slab[:, 4], slab[:, 5], slab[:, 6],
                          slab[:, 7])
    act = ((bs > 0) & (jnp.abs(p0 - q0) < alpha)
           & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    tc0 = tc0_vec[jnp.clip(bs, 1, 3) - 1]
    if chroma:
        tc = tc0 + 1
        delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3,
                         -tc, tc)
        np0 = jnp.clip(p0 + delta, 0, 255)
        nq0 = jnp.clip(q0 - delta, 0, 255)
        sp0 = (2 * p1 + p0 + q1 + 2) >> 2
        sq0 = (2 * q1 + q0 + p1 + 2) >> 2
        strong = bs == 4
        np0 = jnp.where(strong, sp0, np0)
        nq0 = jnp.where(strong, sq0, nq0)
        return jnp.stack([p1, jnp.where(act, np0, p0),
                          jnp.where(act, nq0, q0), q1], axis=1)
    ap = jnp.abs(p2 - p0) < beta
    aq = jnp.abs(q2 - q0) < beta
    # normal filter (bS < 4)
    tc = tc0 + ap.astype(jnp.int32) + aq.astype(jnp.int32)
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = jnp.clip(p0 + delta, 0, 255)
    nq0 = jnp.clip(q0 - delta, 0, 255)
    np1 = p1 + jnp.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1,
                        -tc0, tc0)
    nq1 = q1 + jnp.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1,
                        -tc0, tc0)
    np1 = jnp.where(ap, np1, p1)
    nq1 = jnp.where(aq, nq1, q1)
    # strong filter (bS == 4)
    small = jnp.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = ap & small
    sq = aq & small
    sp0 = jnp.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                    (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = jnp.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = jnp.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = jnp.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                    (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = jnp.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = jnp.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    strong = bs == 4
    np0 = jnp.where(strong, sp0, np0)
    np1 = jnp.where(strong, sp1, np1)
    np2 = jnp.where(strong, sp2, p2)
    nq0 = jnp.where(strong, sq0, nq0)
    nq1 = jnp.where(strong, sq1, nq1)
    nq2 = jnp.where(strong, sq2, q2)
    return jnp.stack(
        [p3,
         jnp.where(act, np2, p2), jnp.where(act, np1, p1),
         jnp.where(act, np0, p0), jnp.where(act, nq0, q0),
         jnp.where(act, nq1, q1), jnp.where(act, nq2, q2),
         q3], axis=1)


def _filter_luma_mb(patch: jax.Array, bsv: jax.Array, bsh: jax.Array,
                    on_left: jax.Array, on_top: jax.Array,
                    alpha, beta, tc0_vec) -> jax.Array:
    """One MB's 8 edges over a (20, 20) patch whose (4, 4) corner is
    the MB origin.  ``bsv``/``bsh`` are (segment, edge)/(edge, segment)
    (4, 4) grids; ``on_left``/``on_top`` gate the MB-boundary edges
    (the bS grids already zero PICTURE boundaries; these zero the
    scratch lanes too)."""
    for e in range(4):
        c = 4 + 4 * e
        bs = jnp.repeat(bsv[:, e], 4)
        if e == 0:
            bs = bs * on_left
        slab = _edge_filter(patch[4:20, c - 4:c + 4], bs, alpha, beta,
                            tc0_vec, chroma=False)
        patch = patch.at[4:20, c - 4:c + 4].set(slab)
    for e in range(4):
        r = 4 + 4 * e
        bs = jnp.repeat(bsh[e, :], 4)
        if e == 0:
            bs = bs * on_top
        slab = _edge_filter(patch[r - 4:r + 4, 4:20].T, bs, alpha,
                            beta, tc0_vec, chroma=False)
        patch = patch.at[r - 4:r + 4, 4:20].set(slab.T)
    return patch


def _filter_chroma_mb(patch: jax.Array, bsv: jax.Array, bsh: jax.Array,
                      on_left: jax.Array, on_top: jax.Array,
                      alpha, beta, tc0_vec) -> jax.Array:
    """One MB's 4 chroma edges over a (10, 10) patch with the MB origin
    at (2, 2).  Chroma edge e maps to luma edge 2e; each luma bS
    segment covers two chroma rows."""
    for e in range(2):
        c = 2 + 4 * e
        bs = jnp.repeat(bsv[:, 2 * e], 2)
        if e == 0:
            bs = bs * on_left
        slab = _edge_filter(patch[2:10, c - 2:c + 2], bs, alpha, beta,
                            tc0_vec, chroma=True)
        patch = patch.at[2:10, c - 2:c + 2].set(slab)
    for e in range(2):
        r = 2 + 4 * e
        bs = jnp.repeat(bsh[2 * e, :], 2)
        if e == 0:
            bs = bs * on_top
        slab = _edge_filter(patch[r - 2:r + 2, 2:10].T, bs, alpha,
                            beta, tc0_vec, chroma=True)
        patch = patch.at[r - 2:r + 2, 2:10].set(slab.T)
    return patch


def _gather(plane, rows, cols):
    return plane[rows[:, :, None], cols[:, None, :]]


def _scatter(plane, rows, cols, patches):
    return plane.at[rows[:, :, None], cols[:, None, :]].set(
        patches, unique_indices=True)


def deblock_planes(y: jax.Array, cb: jax.Array, cr: jax.Array,
                   qp: jax.Array, intra: jax.Array, nnz4: jax.Array,
                   mv: jax.Array, ref: jax.Array,
                   slice_local: bool = False
                   ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Filter one reconstructed picture on device; bit-exact twin of
    ``io.h264_deblock.deblock_picture``.  ``y`` (H, W) uint8 with H, W
    16-aligned; ``qp`` traced int32; metadata shapes as DeblockInfo
    (all-intra IDR pictures: pass ``intra=ones`` and zeros elsewhere).
    Returns uint8 planes.

    ``slice_local`` (static) is ``deblock_picture(slice_local_rows=
    True)``: idc=2 for one-slice-per-MB-row pictures — horizontal MB
    edges are slice boundaries and stay unfiltered (the GDR+deblock
    composition)."""
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    qp = jnp.clip(qp.astype(jnp.int32), 0, 51)
    qpc = jnp.asarray(_QPC_TAB)[qp]
    alpha_t = jnp.asarray(ALPHA, dtype=jnp.int32)
    beta_t = jnp.asarray(BETA, dtype=jnp.int32)
    tc0_t = jnp.asarray(TC0, dtype=jnp.int32)
    al, bl, tl = alpha_t[qp], beta_t[qp], tc0_t[:, qp]
    ac, bc, tc = alpha_t[qpc], beta_t[qpc], tc0_t[:, qpc]

    bs_v, bs_h = bs_grids(intra, nnz4, mv, ref)
    if slice_local:
        bs_h = bs_h.at[::4, :].set(0)
    # pad bS grids to cover the per-lane scratch MB columns with zeros
    scratch_mbs = mb_h
    bs_v = jnp.pad(bs_v, ((0, 0), (0, 4 * scratch_mbs)))
    bs_h = jnp.pad(bs_h, ((0, 0), (0, 4 * scratch_mbs)))

    # padded planes: 4 (2 chroma) halo on every side so patch gathers
    # never go negative, plus the scratch columns on the right
    ypad = jnp.pad(y.astype(jnp.int32),
                   ((4, 4), (4, 4 + 16 * scratch_mbs)))
    cbpad = jnp.pad(cb.astype(jnp.int32),
                    ((2, 2), (2, 2 + 8 * scratch_mbs)))
    crpad = jnp.pad(cr.astype(jnp.int32),
                    ((2, 2), (2, 2 + 8 * scratch_mbs)))

    lanes = jnp.arange(mb_h, dtype=jnp.int32)
    steps = 2 * (mb_h - 1) + mb_w

    filt_l = jax.vmap(_filter_luma_mb,
                      in_axes=(0, 0, 0, 0, 0, None, None, None))
    filt_c = jax.vmap(_filter_chroma_mb,
                      in_axes=(0, 0, 0, 0, 0, None, None, None))
    r20 = jnp.arange(20)
    r10 = jnp.arange(10)
    r4 = jnp.arange(4)

    def step(carry, t):
        yp, cbp, crp = carry
        j = t - 2 * lanes
        active = (j >= 0) & (j < mb_w)
        j_eff = jnp.where(active, j, mb_w + lanes)
        on_left = (active & (j > 0)).astype(jnp.int32)
        on_top = (active & (lanes > 0)).astype(jnp.int32)
        # bS tiles (the grids already zero picture boundaries; scratch
        # columns are all-zero so inactive lanes do identity work)
        brow = 4 * lanes
        bcol = 4 * j_eff
        bsv = _gather(bs_v, brow[:, None] + r4[None, :],
                      bcol[:, None] + r4[None, :])
        bsh = _gather(bs_h, brow[:, None] + r4[None, :],
                      bcol[:, None] + r4[None, :])
        # luma: patch origin in padded coords = (16i-4+4, 16j-4+4)
        rows = 16 * lanes[:, None] + r20[None, :]
        cols = 16 * j_eff[:, None] + r20[None, :]
        patches = _gather(yp, rows, cols)
        patches = filt_l(patches, bsv, bsh, on_left, on_top, al, bl,
                         tl)
        yp = _scatter(yp, rows, cols, patches)
        # chroma
        crows = 8 * lanes[:, None] + r10[None, :]
        ccols = 8 * j_eff[:, None] + r10[None, :]
        for name, plane in (("cb", cbp), ("cr", crp)):
            cpatch = _gather(plane, crows, ccols)
            cpatch = filt_c(cpatch, bsv, bsh, on_left, on_top, ac, bc,
                            tc)
            plane = _scatter(plane, crows, ccols, cpatch)
            if name == "cb":
                cbp = plane
            else:
                crp = plane
        return (yp, cbp, crp), None

    (ypad, cbpad, crpad), _ = jax.lax.scan(
        step, (ypad, cbpad, crpad),
        jnp.arange(steps, dtype=jnp.int32))
    return (ypad[4:4 + H, 4:4 + W].astype(jnp.uint8),
            cbpad[2:2 + H // 2, 2:2 + W // 2].astype(jnp.uint8),
            crpad[2:2 + H // 2, 2:2 + W // 2].astype(jnp.uint8))


# the unfiltered recon is dead once the filtered picture exists
deblock_planes_jit = jax.jit(deblock_planes, donate_argnums=(0, 1, 2),
                             static_argnums=(8,))
