"""Device CAVLC bit-packing: the entropy stage's bit-level work as
part of the device program.

The host entropy stage is the in-repo encoder's only CPU stage
(io/h264_cavlc.py; threaded C++ rows in native/framepipe.cpp).  Its
work is almost entirely *parallel-friendly*: ``total_coeff`` of every
4x4 block is a pure function of the quantized levels, so every nC
context is a shifted array lookup (one slice per MB row means the
only neighbors are LEFT and the within-MB TOP — no raster scan), and
the only sequential state (level ``suffixLength`` adaptation, the
``run_before`` ``zerosLeft`` countdown) lives INSIDE a block, bounded
by 16 steps.  This module therefore:

  1. tokenizes every residual block in parallel (34 fixed token slots
     per block, each a (value, length<=28) pair — spec 9.2's
     coeff_token / trailing-one signs / level prefix+suffix (merged
     into one token) / total_zeros / run_before),
  2. packs each block's tokens into a bit buffer (MSB-first u32
     words) with a 34-step loop, vectorized over all blocks,
  3. concatenates header + 27 block pieces per MB with dynamic
     bit-shifts (28 static steps, vectorized over all MBs),

leaving the host only the slice header, MB-string concatenation,
rbsp trailing bits and emulation prevention (pure numpy bit moves —
no VLC work).  Byte-exactness oracle:
io.h264_cavlc.encode_frame_from_levels (tests/test_h264_bitpack.py).

The VLC tables are built from io/h264_cavlc.py's dicts (spec tables
9-2..9-10) — ONE source of truth.  Every MB's packed size is capped
at ``nw_mb`` u32 words; frames where any MB overflows raise the
``overflow`` flag and the caller falls back to the host entropy path
(byte-identical by construction), so the cap is a transfer-size
trade, not a correctness one.

Reference analogue: the VCU's entropy engine is part of the hardware
encoder (`/root/reference/OpenCVequalHist.cpp:308-332` never sees a
bit of CAVLC on the CPU); this brings the in-repo encoder to the
same shape — pixels AND bits on the accelerator.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opencv_opencl_tpu.io.h264_cavlc import (_CT_NC0, _CT_NC2, _CT_NC4,
                                             _CT_NCM1, _RUN_BEFORE,
                                             _TZ, _TZ_CDC, _ZIGZAG)

# ---------------------------------------------------------------- tables ----

# coeff_token VLC tables (spec 9-2), [nc_class][total][t1s] -> len/code
_CT_LEN = np.zeros((3, 17, 4), np.int32)
_CT_CODE = np.zeros((3, 17, 4), np.int32)
for _k, _tab in enumerate((_CT_NC0, _CT_NC2, _CT_NC4)):
    for (_t, _t1), (_ln, _cd) in _tab.items():
        _CT_LEN[_k, _t, _t1] = _ln
        _CT_CODE[_k, _t, _t1] = _cd
_CDC_LEN = np.zeros((5, 4), np.int32)
_CDC_CODE = np.zeros((5, 4), np.int32)
for (_t, _t1), (_ln, _cd) in _CT_NCM1.items():
    _CDC_LEN[_t, _t1] = _ln
    _CDC_CODE[_t, _t1] = _cd

# total_zeros (9-7/9-8), [total][zeros] — total 1..15
_TZ_LEN = np.zeros((16, 16), np.int32)
_TZ_CODE = np.zeros((16, 16), np.int32)
for _t, _rows in _TZ.items():
    for _z, (_ln, _cd) in enumerate(_rows):
        _TZ_LEN[_t, _z] = _ln
        _TZ_CODE[_t, _z] = _cd
# chroma DC total_zeros (9-9a), total 1..3
_TZC_LEN = np.zeros((4, 4), np.int32)
_TZC_CODE = np.zeros((4, 4), np.int32)
for _t, _rows in _TZ_CDC.items():
    for _z, (_ln, _cd) in enumerate(_rows):
        _TZC_LEN[_t, _z] = _ln
        _TZC_CODE[_t, _z] = _cd
# run_before (9-10), [min(zeros_left,7)][run]
_RB_LEN = np.zeros((8, 15), np.int32)
_RB_CODE = np.zeros((8, 15), np.int32)
for _zl, _rows in _RUN_BEFORE.items():
    for _r, (_ln, _cd) in enumerate(_rows):
        _RB_LEN[_zl, _r] = _ln
        _RB_CODE[_zl, _r] = _cd

_ZZ = np.asarray(_ZIGZAG, np.int32)
# luma AC piece order: _BLOCK_SCAN's (bx, by) pairs as by*4+bx indices
_LUMA_SCAN = np.asarray(
    [by * 4 + bx for bx, by in
     [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
      (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]],
    np.int32)

# token slots per residual block: coeff_token, t1 signs, 16 levels,
# total_zeros, 14 run_before
NT_BLOCK = 33
# block bit bound: 16 + 3 + 16*28 + 9 + 14*11 = 630 -> 20 words
NW_BLOCK = 20


def _ue_token(v):
    """Exp-Golomb ue(v) as one (value, length) token (v < 2^15)."""
    code = v + 1
    nbits = jnp.zeros_like(v)
    for k in range(16):
        nbits = nbits + (code > ((1 << k) - 1))
    return code, 2 * nbits - 1


def block_tokens(lv, nc, max_coeffs: int, cdc: bool):
    """Tokenize residual blocks (spec 9.2): ``lv`` (..., C) int32
    scanned coefficients (LOW->HIGH frequency), ``nc`` the (...)-shaped
    nC context (ignored when ``cdc``).  Returns (vals, lens), each
    (..., NT_BLOCK) int32 — zero-length slots are no-ops.  Mirrors
    io.h264_cavlc._write_residual_block decision for decision."""
    C = lv.shape[-1]
    lv = lv.astype(jnp.int32)
    nzm = (lv != 0).astype(jnp.int32)
    total = jnp.sum(nzm, -1)
    # rank from the high-frequency end (rank 0 = highest nonzero)
    rank = (jnp.cumsum(nzm[..., ::-1], -1)[..., ::-1] - nzm)
    # value/position at each rank via one-hot (C x C per block)
    R = jnp.where(nzm > 0, rank, C)
    onehot = (R[..., None, :] == jnp.arange(C, dtype=jnp.int32)
              [:, None]).astype(jnp.int32)
    vr = jnp.sum(onehot * lv[..., None, :], -1)        # (..., C)
    pr = jnp.sum(onehot * jnp.arange(C, dtype=jnp.int32), -1)
    av = jnp.abs(vr)
    # trailing ones (<= 3, from rank 0, stop at first non-one)
    a0 = (av[..., 0] == 1) & (total >= 1)
    a1 = a0 & (av[..., 1] == 1) & (total >= 2) if C > 1 else a0 & False
    a2 = a1 & (av[..., 2] == 1) & (total >= 3) if C > 2 else a1 & False
    t1s = (a0.astype(jnp.int32) + a1.astype(jnp.int32)
           + a2.astype(jnp.int32))

    vals = []
    lens = []
    # --- slot 0: coeff_token
    if cdc:
        ct_len = jnp.asarray(_CDC_LEN)[total, t1s]
        ct_code = jnp.asarray(_CDC_CODE)[total, t1s]
    else:
        tab = jnp.where(nc < 2, 0, jnp.where(nc < 4, 1, 2))
        flc = nc >= 8
        ct_len = jnp.where(flc, 6,
                           jnp.asarray(_CT_LEN)[tab, total, t1s])
        ct_code = jnp.where(
            flc, jnp.where(total == 0, 0b000011,
                           ((total - 1) << 2) | t1s),
            jnp.asarray(_CT_CODE)[tab, total, t1s])
    vals.append(ct_code)
    lens.append(ct_len)
    # --- slot 1: trailing one signs (high frequency first, 1=neg)
    signs = jnp.zeros_like(total)
    for j in range(min(3, C)):
        use = j < t1s
        signs = jnp.where(use, (signs << 1) | (vr[..., j] < 0), signs)
    vals.append(signs)
    lens.append(t1s)
    # --- slots 2..2+C-1: remaining levels (high frequency first)
    suffix_len = jnp.where((total > 10) & (t1s < 3), 1, 0)
    for r in range(C):
        emit = (r >= t1s) & (r < total)
        c = vr[..., r]
        lc = jnp.where(c > 0, 2 * c - 2, -2 * c - 1)
        lc = lc - 2 * ((r == t1s) & (t1s < 3)).astype(jnp.int32)
        sl = suffix_len
        # merged prefix+suffix token per case
        prefix = lc >> jnp.clip(sl, 0, 6)
        esc = jnp.where(sl == 0, lc >= 30, prefix >= 15)
        mid0 = (sl == 0) & (lc >= 14) & (lc < 30)   # prefix-14 escape
        v_pl = jnp.where(
            sl == 0,
            jnp.where(mid0, (1 << 4) | (lc - 14), 1),
            (1 << sl) | (lc & ((1 << sl) - 1)))
        l_pl = jnp.where(
            sl == 0,
            jnp.where(mid0, 19, lc + 1),
            prefix + 1 + sl)
        v_esc = (1 << 12) | (lc - jnp.where(sl == 0, 30, 15 << sl))
        tok_v = jnp.where(esc, v_esc, v_pl)
        tok_l = jnp.where(esc, 28, l_pl)
        vals.append(jnp.where(emit, tok_v, 0))
        lens.append(jnp.where(emit, tok_l, 0))
        # state update (exact oracle order)
        sl2 = jnp.where(sl == 0, 1, sl)
        sl2 = sl2 + ((jnp.abs(c) > (3 << jnp.clip(sl2 - 1, 0, 5)))
                     & (sl2 < 6)).astype(jnp.int32)
        suffix_len = jnp.where(emit, sl2, sl)
    for _ in range(C, 16):
        z = jnp.zeros_like(total)
        vals.append(z)
        lens.append(z)
    # --- slot 18: total_zeros
    tz = pr[..., 0] + 1 - total
    emit_tz = (total > 0) & (total < max_coeffs)
    if cdc:
        tz_len = jnp.asarray(_TZC_LEN)[jnp.clip(total, 0, 3),
                                       jnp.clip(tz, 0, 3)]
        tz_code = jnp.asarray(_TZC_CODE)[jnp.clip(total, 0, 3),
                                         jnp.clip(tz, 0, 3)]
    else:
        tz_len = jnp.asarray(_TZ_LEN)[jnp.clip(total, 0, 15),
                                      jnp.clip(tz, 0, 15)]
        tz_code = jnp.asarray(_TZ_CODE)[jnp.clip(total, 0, 15),
                                        jnp.clip(tz, 0, 15)]
    vals.append(jnp.where(emit_tz, tz_code, 0))
    lens.append(jnp.where(emit_tz, tz_len, 0))
    # --- slots 19..: run_before (high frequency first; the lowest
    # coefficient carries no run).  tz is garbage when total == 0 but
    # every slot is gated on total >= 2 then.
    zl = tz
    for r in range(min(C - 1, 14)):
        emit = (r <= total - 2) & (zl > 0)
        run = pr[..., r] - (pr[..., r + 1] if r + 1 < C
                            else jnp.zeros_like(total)) - 1
        runc = jnp.clip(run, 0, 14)
        zlc = jnp.clip(zl, 0, 7)
        vals.append(jnp.where(emit, jnp.asarray(_RB_CODE)[zlc, runc],
                              0))
        lens.append(jnp.where(emit, jnp.asarray(_RB_LEN)[zlc, runc],
                              0))
        zl = zl - jnp.where(emit, runc, 0)
    while len(vals) < NT_BLOCK:
        z = jnp.zeros_like(total)
        vals.append(z)
        lens.append(z)
    return (jnp.stack(vals, -1), jnp.stack(lens, -1))


def pack_tokens(vals, lens, nw: int):
    """Pack (..., NT) (value, length) tokens into (..., nw) MSB-first
    uint32 words + total bit count.  Bits beyond the count are zero
    (required by the concat stage's OR-placement)."""
    nt = vals.shape[-1]
    words = jnp.zeros(vals.shape[:-1] + (nw,), jnp.uint32)
    pos = jnp.zeros(vals.shape[:-1], jnp.int32)
    widx = jnp.arange(nw, dtype=jnp.int32)
    for t in range(nt):
        v = vals[..., t].astype(jnp.uint32)
        ln = lens[..., t]
        wi = pos >> 5
        off = pos & 31
        rem = 32 - off
        spill = ln > rem
        hi = jnp.where(
            spill,
            v >> jnp.clip(ln - rem, 0, 31).astype(jnp.uint32),
            v << jnp.clip(rem - ln, 0, 31).astype(jnp.uint32))
        lo = jnp.where(
            spill,
            v << jnp.clip(32 - (ln - rem), 1, 31).astype(jnp.uint32),
            jnp.uint32(0))
        words = (words
                 | jnp.where(widx == wi[..., None], hi[..., None],
                             jnp.uint32(0))
                 | jnp.where(widx == wi[..., None] + 1, lo[..., None],
                             jnp.uint32(0)))
        pos = pos + ln
    return words, pos


def concat_pieces(piece_words, piece_bits, nw_out: int):
    """Concatenate P bit-strings per lane: ``piece_words``
    (..., P, NWp) uint32, ``piece_bits`` (..., P).  Returns
    ((..., nw_out) words, total bits).  Bits beyond each piece's
    count MUST be zero."""
    P, nwp = piece_words.shape[-2], piece_words.shape[-1]
    out = jnp.zeros(piece_words.shape[:-2] + (nw_out,), jnp.uint32)
    pos = jnp.zeros(piece_words.shape[:-2], jnp.int32)
    oidx = jnp.arange(nw_out, dtype=jnp.int32)
    for p in range(P):
        w = piece_words[..., p, :]
        off = (pos & 31).astype(jnp.uint32)[..., None]
        # shift the piece right by off with cross-word carry (+1 word)
        wl = jnp.concatenate(
            [jnp.zeros(w.shape[:-1] + (1,), jnp.uint32), w], -1)
        wr = jnp.concatenate(
            [w, jnp.zeros(w.shape[:-1] + (1,), jnp.uint32)], -1)
        carry = jnp.where(off > 0,
                          wl << jnp.clip(32 - off, 0, 31), 0)
        shifted = (wr >> off) | carry          # (..., nwp + 1)
        # place at word offset pos >> 5
        rel = oidx - (pos >> 5)[..., None]     # (..., nw_out)
        ok = (rel >= 0) & (rel <= nwp)
        gathered = jnp.take_along_axis(
            shifted, jnp.clip(rel, 0, nwp), axis=-1)
        out = out | jnp.where(ok, gathered, jnp.uint32(0))
        pos = pos + piece_bits[..., p]
    return out, pos


# ------------------------------------------------------- I-frame packing ----


def _luma_nc(lnnz):
    """nC context grid for the 16 luma AC blocks of every MB (one
    slice per MB row: left neighbor crosses MBs, top stays within the
    MB).  ``lnnz`` (mb_h, mb_w, 16) per-block total_coeff.  Returns
    (nc (mb_h, mb_w, 16), dc_nc (mb_h, mb_w))."""
    mb_h, mb_w = lnnz.shape[:2]
    grid = (lnnz.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3)
            .reshape(mb_h, 4, mb_w * 4))
    left = jnp.pad(grid, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
    top = jnp.pad(grid, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
    x = jnp.arange(mb_w * 4, dtype=jnp.int32)
    nc0 = left[:, 0:1]                              # by = 0
    ncn = jnp.where(x > 0, (left[:, 1:] + top[:, 1:] + 1) >> 1,
                    top[:, 1:])                     # by >= 1
    nc = jnp.concatenate([nc0, ncn], 1)
    nc = (nc.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3)
          .reshape(mb_h, mb_w, 16))
    dc_nc = left[:, 0].reshape(mb_h, mb_w, 4)[:, :, 0]
    return nc, dc_nc


def _chroma_nc(cnnz):
    """nC grid for one component's 4 chroma AC blocks,
    ``cnnz`` (mb_h, mb_w, 4)."""
    mb_h, mb_w = cnnz.shape[:2]
    grid = (cnnz.reshape(mb_h, mb_w, 2, 2).transpose(0, 2, 1, 3)
            .reshape(mb_h, 2, mb_w * 2))
    left = jnp.pad(grid, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
    top = jnp.pad(grid, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
    x = jnp.arange(mb_w * 2, dtype=jnp.int32)
    nc0 = left[:, 0:1]
    ncn = jnp.where(x > 0, (left[:, 1:] + top[:, 1:] + 1) >> 1,
                    top[:, 1:])
    nc = jnp.concatenate([nc0, ncn], 1)
    return (nc.reshape(mb_h, 2, mb_w, 2).transpose(0, 2, 1, 3)
            .reshape(mb_h, mb_w, 4))


# z-scan index of the raster 4x4 block (bx, by) — kZOf in the C++
# rows; flattened raster-major [by * 4 + bx] -> z.  The permutation is
# an involution, so it also maps z -> raster.
_Z_OF_RASTER = np.asarray(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15], np.int32)
# (bx, by) of z-scan position z (io.h264_cavlc._BLOCK_SCAN)
_I4_SCAN_BXBY = ((0, 0), (1, 0), (0, 1), (1, 1),
                 (2, 0), (3, 0), (2, 1), (3, 1),
                 (0, 2), (1, 2), (0, 3), (1, 3),
                 (2, 2), (3, 2), (2, 3), (3, 3))


def pack_i_mbs(zdc, acz, czdc, cacz, imode, nw_mb: int = 64,
               i4modes=None, cmode=None):
    """Pack every intra MB of one frame into its bitstring (device;
    oracle io.h264_cavlc.encode_frame_from_levels MB body).  Level
    layouts are LevelArrays' (ops/h264_levels.py).  ``imode`` 0 marks
    Intra_4x4 MBs (acz slots then carry FULL 16-coeff blocks and
    ``i4modes`` the z-scan block modes); ``cmode`` the per-MB
    intra_chroma_pred_mode plane.  Returns (words (mb_h, mb_w, nw_mb)
    uint32, nbits (mb_h, mb_w) int32) — an MB whose true size exceeds
    the cap reports its TRUE nbits (the overflow signal) with
    truncated words."""
    mb_h, mb_w = zdc.shape[:2]
    zdc = zdc.astype(jnp.int32)
    acz = acz.astype(jnp.int32)
    czdc = czdc.astype(jnp.int32)
    cacz = cacz.astype(jnp.int32)
    lnnz = jnp.sum((acz != 0).astype(jnp.int32), -1)
    cnnz = jnp.sum((cacz != 0).astype(jnp.int32), -1)  # (mbh,mbw,2,4)
    cbp_luma = (jnp.sum(lnnz, -1) > 0).astype(jnp.int32)
    cbp_chroma = jnp.where(
        jnp.any(cacz != 0, axis=(-1, -2, -3)), 2,
        jnp.where(jnp.any(czdc != 0, axis=(-1, -2)), 1, 0))

    nc_l, nc_dc = _luma_nc(lnnz)
    nc_cb = _chroma_nc(cnnz[:, :, 0])
    nc_cr = _chroma_nc(cnnz[:, :, 1])

    pm = (jnp.full((mb_h, mb_w), 2, jnp.int32) if imode is None
          else imode.astype(jnp.int32))
    i4sel = (pm == 0) if i4modes is not None else None
    cmv = (jnp.zeros((mb_h, mb_w), jnp.int32) if cmode is None
           else cmode.astype(jnp.int32))
    cm_v, cm_l = _ue_token(cmv)
    mbt = 1 + pm + 4 * cbp_chroma + 12 * cbp_luma
    uev, uel = _ue_token(mbt)
    ones = jnp.ones((mb_h, mb_w), jnp.int32)
    if i4sel is None:
        # header: mb_type ue, intra_chroma_pred_mode ue, mb_qp_delta
        # se(0) (the 1-bit code '1')
        hdr_w, hdr_n = pack_tokens(
            jnp.stack([uev, cm_v, ones], -1),
            jnp.stack([uel, cm_l, ones], -1), 2)
        hdr_w = jnp.pad(hdr_w, ((0, 0), (0, 0), (0, NW_BLOCK - 2)))
    else:
        # --- Intra_4x4 header (device twin of the oracle's i4 branch
        # / the C++ entropy_i4_mb): mb_type ue(0), 16 per-block mode
        # tokens against the one-row-slice predicted-mode derivation,
        # chroma mode, Table 9-4 intra cbp me(v), conditional qp_delta
        from opencv_opencl_tpu.io.h264_cavlc import _CBP_INTRA_CODE

        zm = i4modes.astype(jnp.int32)          # (mbh, mbw, 16) z-scan
        blk_nz = (lnnz > 0)[..., jnp.asarray(_Z_OF_RASTER)]
        # (mbh, mbw, 16) in z order -> per-z-group cbp bits
        qnz = blk_nz.reshape(mb_h, mb_w, 4, 4).any(-1)
        cbpl = (qnz[..., 0].astype(jnp.int32)
                | (qnz[..., 1].astype(jnp.int32) << 1)
                | (qnz[..., 2].astype(jnp.int32) << 2)
                | (qnz[..., 3].astype(jnp.int32) << 3))
        cbp4 = cbpl | (cbp_chroma << 4)
        cbp4_v, cbp4_l = _ue_token(
            jnp.asarray(_CBP_INTRA_CODE.astype(np.int32))[cbp4])
        # left-MB mode context (one masked shift)
        l_is_i4 = jnp.concatenate(
            [jnp.zeros((mb_h, 1), bool), i4sel[:, :-1]], 1)
        lzm = jnp.concatenate(
            [jnp.full((mb_h, 1, 16), 2, jnp.int32), zm[:, :-1]], 1)
        mode_v, mode_l = [], []
        zof = _Z_OF_RASTER.reshape(4, 4)        # [by][bx] -> z
        for z in range(16):
            bx, by = _I4_SCAN_BXBY[z]
            if by == 0:
                predm = jnp.full((mb_h, mb_w), 2, jnp.int32)
            else:
                mb_ = zm[:, :, int(zof[by - 1][bx])]
                if bx > 0:
                    predm = jnp.minimum(zm[:, :, int(zof[by][bx - 1])],
                                        mb_)
                else:
                    la = jnp.where(l_is_i4,
                                   lzm[:, :, int(zof[by][3])], 2)
                    avail = jnp.broadcast_to(
                        jnp.arange(mb_w, dtype=jnp.int32)[None, :] > 0,
                        (mb_h, mb_w))
                    predm = jnp.where(avail, jnp.minimum(la, mb_), 2)
            m = zm[:, :, z]
            match = m == predm
            rem = jnp.where(m < predm, m, m - 1)
            # prev flag ('1') or '0' + 3-bit rem: value packs both
            mode_v.append(jnp.where(match, 1, rem))
            mode_l.append(jnp.where(match, 1, 4))
        hdr16_v = jnp.stack(
            [jnp.where(i4sel, 1, uev), *[
                jnp.where(i4sel, v, 0) for v in mode_v],
             cm_v,
             jnp.where(i4sel, cbp4_v, ones),
             jnp.where(i4sel, ones, 0)], -1)
        hdr16_l = jnp.stack(
            [jnp.where(i4sel, 1, uel), *[
                jnp.where(i4sel, l, 0) for l in mode_l],
             cm_l,
             jnp.where(i4sel, cbp4_l, ones),
             jnp.where(i4sel, (cbp4 != 0).astype(jnp.int32), 0)], -1)
        hdr_w, hdr_n = pack_tokens(hdr16_v, hdr16_l, 4)
        hdr_w = jnp.pad(hdr_w, ((0, 0), (0, 0), (0, NW_BLOCK - 4)))

    zz = jnp.asarray(_ZZ)
    dc_v, dc_l = block_tokens(zdc[..., zz], nc_dc, 16, False)
    dc_w, dc_n = pack_tokens(dc_v, dc_l, NW_BLOCK)
    if i4sel is not None:       # I_4x4: no luma DC block
        dc_w = dc_w * (~i4sel)[..., None].astype(jnp.uint32)
        dc_n = dc_n * (~i4sel)

    ac_v, ac_l = block_tokens(acz[..., zz[1:]], nc_l, 15, False)
    ac_w, ac_n = pack_tokens(ac_v, ac_l, NW_BLOCK)
    gate_l = cbp_luma[..., None]
    if i4sel is not None:
        # both variants packed, selected per MB: i16 keeps the 15+DC
        # shape; i4 blocks carry 16 coefficients gated per z-group
        ac4_v, ac4_l = block_tokens(acz[..., zz], nc_l, 16, False)
        ac4_w, ac4_n = pack_tokens(ac4_v, ac4_l, NW_BLOCK)
        bq = np.asarray([(bx >= 2) + 2 * (by >= 2)
                         for by in range(4) for bx in range(4)],
                        np.int32)
        quad4 = jnp.stack(
            [qnz[..., 0], qnz[..., 1], qnz[..., 2], qnz[..., 3]],
            -1).astype(jnp.int32)
        # z-group index of raster block b is the SPATIAL quadrant
        qg = jnp.take_along_axis(
            quad4, jnp.broadcast_to(jnp.asarray(bq),
                                    (mb_h, mb_w, 16)), -1)
        g16 = (~i4sel)[..., None].astype(jnp.int32) * gate_l
        g4 = i4sel[..., None].astype(jnp.int32) * qg
        ac_w = (ac_w * g16[..., None].astype(jnp.uint32)
                + ac4_w * g4[..., None].astype(jnp.uint32))
        ac_n = ac_n * g16 + ac4_n * g4
    else:
        ac_w = ac_w * gate_l[..., None].astype(jnp.uint32)
        ac_n = ac_n * gate_l
    ac_w = ac_w[:, :, jnp.asarray(_LUMA_SCAN)]      # piece order
    ac_n = ac_n[:, :, jnp.asarray(_LUMA_SCAN)]

    cdc_v, cdc_l = block_tokens(czdc, jnp.zeros_like(czdc[..., 0]),
                                4, True)
    cdc_w, cdc_n = pack_tokens(cdc_v, cdc_l, NW_BLOCK)
    gate_c = (cbp_chroma >= 1)[..., None]
    cdc_w = cdc_w * gate_c[..., None].astype(jnp.uint32)
    cdc_n = cdc_n * gate_c

    nc_c = jnp.stack([nc_cb, nc_cr], 2)             # (mbh,mbw,2,4)
    cac_v, cac_l = block_tokens(cacz[..., zz[1:]], nc_c, 15, False)
    cac_w, cac_n = pack_tokens(cac_v, cac_l, NW_BLOCK)
    gate_a = (cbp_chroma == 2)[..., None, None]
    cac_w = cac_w * gate_a[..., None].astype(jnp.uint32)
    cac_n = cac_n * gate_a
    cac_w = cac_w.reshape(mb_h, mb_w, 8, NW_BLOCK)
    cac_n = cac_n.reshape(mb_h, mb_w, 8)

    pieces_w = jnp.concatenate(
        [hdr_w[:, :, None], dc_w[:, :, None], ac_w,
         cdc_w, cac_w], 2)                          # (mbh,mbw,28,20)
    pieces_n = jnp.concatenate(
        [hdr_n[:, :, None], dc_n[:, :, None], ac_n,
         cdc_n, cac_n], 2)
    return concat_pieces(pieces_w, pieces_n, nw_mb)


# ------------------------------------------------------- P-frame packing ----


def _median3(a, b, c):
    """Component-wise median (the jnp twin of io.h264_inter._median2,
    vectorized for the parts predictor)."""
    return jnp.maximum(jnp.minimum(a, b),
                       jnp.minimum(jnp.maximum(a, b), c))


def _mvp_general_vec(amv, aref, aav, bmv, bref, bav, cmv, cref, cav,
                     myref):
    """Vectorized spec 8.4.1.3.1 general process (the jnp twin of the
    oracle's _mvp_parts general step): copy rule, exactly-one-refIdx-
    match, else component median.  mv args are (..., 2) int32; ref
    (...,); av (...,) bool (constants broadcast)."""
    eamv = jnp.where(aav[..., None], amv, 0)
    ebmv = jnp.where(bav[..., None], bmv, 0)
    ecmv = jnp.where(cav[..., None], cmv, 0)
    ear = jnp.where(aav, aref, -1)
    ebr = jnp.where(bav, bref, -1)
    ecr = jnp.where(cav, cref, -1)
    copy = (~bav) & (~cav) & aav
    ma = ear == myref
    mb_ = ebr == myref
    mc = ecr == myref
    nm = (ma.astype(jnp.int32) + mb_.astype(jnp.int32)
          + mc.astype(jnp.int32))
    sel = jnp.where(ma[..., None], eamv,
                    jnp.where(mb_[..., None], ebmv, ecmv))
    med = _median3(eamv, ebmv, ecmv)
    out = jnp.where((nm == 1)[..., None], sel, med)
    return jnp.where(copy[..., None], eamv, out)


def pack_p_mbs(mode, zdc, acz, czdc, cacz, mv, ref, active_refs,
               nw_mb: int = 64, pmode=None, mv4=None, ref4=None):
    """Pack every MB of one P frame (device; oracle
    io.h264_inter.encode_frame_p_from_levels MB body).  ``mode``
    (mb_h, mb_w): 0 skip, 1 inter, 2 intra-DC, 3 intra-HORIZONTAL;
    ``mv`` the quarter-pel field (None == zero motion); ``ref`` the
    per-MB reference (None == 0); ``active_refs`` a TRACED int32 (the
    ref_idx te(v) bit appears only when it is 2 — traced so the
    first-P-after-IDR frame reuses the compiled program).

    P specifics, all still raster-free: the skip run before each
    coded MB is ``x - 1 - cummax(coded ? x : -1)`` over the row; the
    MV predictor is the LEFT MB's vector gated on it being inter
    (P_Skip carries (0,0) and intra resets to (0,0) — one masked
    shift); inter luma blocks carry 16 coefficients gated per 8x8
    quadrant while intra-in-P keeps the I-frame 15+DC shape — both
    variants are packed and selected per MB.  Skipped MBs report
    nbits=0 (the slice-end run is the host's, from the mode row).

    Returns (words (mb_h, mb_w, nw_mb) uint32, nbits (mb_h, mb_w))."""
    from opencv_opencl_tpu.io.h264_inter import _CBP_INTER_CODENUM

    mb_h, mb_w = mode.shape
    mode = mode.astype(jnp.int32)
    zdc = zdc.astype(jnp.int32)
    acz = acz.astype(jnp.int32)
    czdc = czdc.astype(jnp.int32)
    cacz = cacz.astype(jnp.int32)
    active_refs = jnp.asarray(active_refs, jnp.int32)
    if mv is None:
        mv = jnp.zeros((mb_h, mb_w, 2), jnp.int32)
    mv = mv.astype(jnp.int32)
    refsel = (jnp.zeros((mb_h, mb_w), jnp.int32) if ref is None
              else ref.astype(jnp.int32))
    coded = mode != 0
    intra = mode >= 2

    # nC grids: nnz is a pure function of the levels, zeroed at skips
    lnnz = jnp.sum((acz != 0).astype(jnp.int32), -1) * coded[..., None]
    cnnz = (jnp.sum((cacz != 0).astype(jnp.int32), -1)
            * coded[..., None, None])
    nc_l, nc_dc = _luma_nc(lnnz)
    nc_cb = _chroma_nc(cnnz[:, :, 0])
    nc_cr = _chroma_nc(cnnz[:, :, 1])

    cbp_chroma = jnp.where(
        jnp.any(cacz != 0, axis=(-1, -2, -3)), 2,
        jnp.where(jnp.any(czdc != 0, axis=(-1, -2)), 1, 0)) * coded
    cbp_luma_i = (jnp.sum(lnnz, -1) > 0).astype(jnp.int32)
    # inter CBP: one bit per 8x8 quadrant (block q = (bx>=2) + 2*(by>=2))
    blk_nz = (lnnz > 0).reshape(mb_h, mb_w, 4, 4)
    quad = jnp.stack([
        blk_nz[:, :, :2, :2].any((-1, -2)),
        blk_nz[:, :, :2, 2:].any((-1, -2)),
        blk_nz[:, :, 2:, :2].any((-1, -2)),
        blk_nz[:, :, 2:, 2:].any((-1, -2))], -1).astype(jnp.int32)
    cbp_bits = (quad[..., 0] | (quad[..., 1] << 1)
                | (quad[..., 2] << 2) | (quad[..., 3] << 3))
    cbp = cbp_bits | (cbp_chroma << 4)

    # skip run before each coded MB (cummax over the row)
    xs = jnp.arange(mb_w, dtype=jnp.int32)
    prev = jax.lax.cummax(jnp.where(coded, xs, -1), axis=1)
    prev = jnp.concatenate(
        [jnp.full((mb_h, 1), -1, jnp.int32), prev[:, :-1]], 1)
    skip_run = xs - prev - 1

    def _se_token(v):
        return _ue_token(jnp.where(v > 0, 2 * v - 1, -2 * v))

    one = jnp.ones((mb_h, mb_w), jnp.int32)
    sr_v, sr_l = _ue_token(skip_run)
    pm = jnp.where(mode == 3, 1, 2)
    mbt_i_v, mbt_i_l = _ue_token(5 + 1 + pm + 4 * cbp_chroma
                                 + 12 * cbp_luma_i)
    cbp_v, cbp_l = _ue_token(
        jnp.asarray(_CBP_INTER_CODENUM.astype(np.int32))[cbp])
    dqp_l = (cbp != 0).astype(jnp.int32)
    ii = intra.astype(jnp.int32)
    if pmode is None:
        # MV predictor: the left MB's vector when it is INTER (skip
        # carries (0,0), intra resets to (0,0)) — one masked shift
        left_inter = jnp.concatenate(
            [jnp.zeros((mb_h, 1), bool), (mode == 1)[:, :-1]], 1)
        left_mv = jnp.concatenate(
            [jnp.zeros((mb_h, 1, 2), jnp.int32), mv[:, :-1]], 1)
        mvp = jnp.where(left_inter[..., None], left_mv, 0)
        mvd = mv - mvp

        # --- header: 8 token slots covering both MB kinds
        ref_l = jnp.where(jnp.logical_and(~intra, active_refs == 2),
                          1, 0)
        ref_v = jnp.where(ref_l > 0, 1 - refsel, 0)
        mvdx_v, mvdx_l = _se_token(mvd[..., 1])
        mvdy_v, mvdy_l = _se_token(mvd[..., 0])
        hdr_v = jnp.stack([
            sr_v,
            jnp.where(intra, mbt_i_v, 1),
            jnp.where(intra, one, ref_v),       # ue(0) | te ref
            jnp.where(intra, one, mvdx_v),      # se(0) | se(mvd_x)
            jnp.where(intra, 0, mvdy_v),
            jnp.where(intra, 0, cbp_v),
            jnp.where(intra, 0, one),           # - | se(0) if cbp
            jnp.zeros_like(one)], -1)
        hdr_l = jnp.stack([
            sr_l,
            jnp.where(intra, mbt_i_l, 1),
            jnp.where(intra, one, ref_l),
            jnp.where(intra, one, mvdx_l),
            jnp.where(intra, 0, mvdy_l),
            jnp.where(intra, 0, cbp_l),
            jnp.where(intra, 0, dqp_l),
            jnp.zeros_like(one)], -1)
        hdr_w, hdr_n = pack_tokens(hdr_v, hdr_l, 3)
        hdr_w = jnp.pad(hdr_w, ((0, 0), (0, 0), (0, NW_BLOCK - 3)))
    else:
        # --- partitioned header (device twin of the oracle's
        # entropy_p_mb_parts / the Python parts writer): mb_type =
        # pmode, sub_mb_types, per-partition te(v) refs (traced
        # active_refs), per-partition mvd against the reference-aware
        # _mvp_parts predictor (io/h264_inter.py; the general process
        # vectorizes as _mvp_general_vec)
        pmode = pmode.astype(jnp.int32)
        mv4 = mv4.astype(jnp.int32)             # (mb_h, mb_w, 4, 2)
        r4 = (jnp.zeros((mb_h, mb_w, 4), jnp.int32) if ref4 is None
              else ref4.astype(jnp.int32))
        # left MB quadrant context (one masked shift; skip rows carry
        # (0, 0)/ref 0 — their searched field IS zero by the skip
        # guard — and intra rows mask out via left_inter)
        left_inter = jnp.concatenate(
            [jnp.zeros((mb_h, 1), bool), (mode == 1)[:, :-1]], 1)
        left_avail = jnp.broadcast_to(
            jnp.arange(mb_w, dtype=jnp.int32)[None, :] > 0,
            (mb_h, mb_w))
        lmv = jnp.concatenate(
            [jnp.zeros((mb_h, 1, 4, 2), jnp.int32), mv4[:, :-1]], 1)
        lrf = jnp.concatenate(
            [jnp.zeros((mb_h, 1, 4), jnp.int32), r4[:, :-1]], 1)
        # skipped left MBs: quadrants (0,0)/ref 0 (mode==0 rows may
        # carry a searched field only when pmode 0 mv 0 — already 0)
        lskip = jnp.concatenate(
            [jnp.zeros((mb_h, 1), bool), (mode == 0)[:, :-1]], 1)
        lmv = jnp.where(lskip[..., None, None], 0, lmv)
        lrf = jnp.where(lskip[..., None], 0, lrf)
        li = left_inter | lskip
        a1mv = jnp.where(li[..., None], lmv[:, :, 1], 0)
        a3mv = jnp.where(li[..., None], lmv[:, :, 3], 0)
        a1r = jnp.where(li, lrf[:, :, 1], -1)
        a3r = jnp.where(li, lrf[:, :, 3], -1)
        FALSE = jnp.zeros((mb_h, mb_w), bool)
        TRUE = jnp.ones((mb_h, mb_w), bool)
        Z2 = jnp.zeros((mb_h, mb_w, 2), jnp.int32)
        ZR = jnp.full((mb_h, mb_w), -1, jnp.int32)
        own = [mv4[:, :, q] for q in range(4)]
        ownr = [r4[:, :, q] for q in range(4)]
        reps = jnp.asarray(
            [[0, 0, 0, 0], [0, 2, 0, 0], [0, 1, 0, 0], [0, 1, 2, 3]],
            jnp.int32)[pmode]                   # (mb_h, mb_w, 4)
        nparts = jnp.asarray([1, 2, 2, 4], jnp.int32)[pmode]
        mvd_v, mvd_l = [], []
        ref_vs, ref_ls = [], []
        for p in range(4):
            rep = reps[:, :, p]
            myref = jnp.take_along_axis(
                r4, rep[..., None], -1)[..., 0]
            pmv = jnp.take_along_axis(
                mv4, rep[..., None, None].repeat(2, -1), -2)[:, :, 0]
            if p == 0:
                mvp = _mvp_general_vec(a1mv, a1r, left_avail,
                                       Z2, ZR, FALSE, Z2, ZR, FALSE,
                                       myref)
            elif p == 1:
                # pmode 1 bottom: directional A (left q3) on refIdx
                # match, else general(A=left q3, B=own top, C->D=left
                # q1); pmode 2 right / pmode 3 q1: copy rule -> own q0
                dirm = left_avail & (a3r == myref)
                gen = _mvp_general_vec(a3mv, a3r, left_avail,
                                       own[0], ownr[0], TRUE,
                                       a1mv, a1r, left_avail, myref)
                c1 = jnp.where(dirm[..., None], a3mv, gen)
                mvp = jnp.where((pmode == 1)[..., None], c1, own[0])
            elif p == 2:
                mvp = _mvp_general_vec(a3mv, a3r, left_avail,
                                       own[0], ownr[0], TRUE,
                                       own[1], ownr[1], TRUE, myref)
            else:
                mvp = _mvp_general_vec(own[2], ownr[2], TRUE,
                                       own[1], ownr[1], TRUE,
                                       own[0], ownr[0], TRUE, myref)
            active = jnp.logical_and(~intra, p < nparts)
            d = pmv - mvp
            vx, lx = _se_token(d[..., 1])
            vy, ly = _se_token(d[..., 0])
            mvd_v += [jnp.where(active, vx, 0),
                      jnp.where(active, vy, 0)]
            mvd_l += [jnp.where(active, lx, 0),
                      jnp.where(active, ly, 0)]
            ract = jnp.logical_and(active, active_refs == 2)
            ref_vs.append(jnp.where(ract, 1 - myref, 0))
            ref_ls.append(jnp.where(ract, 1, 0))
        mbt_p_v, mbt_p_l = _ue_token(pmode)
        subl = jnp.where(jnp.logical_and(~intra, pmode == 3), 1, 0)
        hdr_v = jnp.stack([
            sr_v,
            jnp.where(intra, mbt_i_v, mbt_p_v),
            jnp.where(intra, one, subl),        # ue(0)chroma | sub0
            jnp.where(intra, one, subl),        # se(0)qp | sub1
            jnp.where(intra, 0, subl),          # sub2
            jnp.where(intra, 0, subl),          # sub3
            *ref_vs, *mvd_v,
            jnp.where(intra, 0, cbp_v),
            jnp.where(intra, 0, one)], -1)      # se(0) if cbp
        hdr_l = jnp.stack([
            sr_l,
            jnp.where(intra, mbt_i_l, mbt_p_l),
            jnp.where(intra, one, subl),
            jnp.where(intra, one, subl),
            jnp.where(intra, 0, subl),
            jnp.where(intra, 0, subl),
            *ref_ls, *mvd_l,
            jnp.where(intra, 0, cbp_l),
            jnp.where(intra, 0, dqp_l)], -1)
        hdr_w, hdr_n = pack_tokens(hdr_v, hdr_l, 8)
        hdr_w = jnp.pad(hdr_w, ((0, 0), (0, 0), (0, NW_BLOCK - 8)))

    zz = jnp.asarray(_ZZ)
    # luma DC: intra-in-P only
    dc_v, dc_l = block_tokens(zdc[..., zz], nc_dc, 16, False)
    dc_w, dc_n = pack_tokens(dc_v, dc_l, NW_BLOCK)
    gate_dc = ii[..., None]
    dc_w = dc_w * gate_dc.astype(jnp.uint32)
    dc_n = dc_n * ii

    # luma AC: both variants packed, selected per MB
    aci_v, aci_l = block_tokens(acz[..., zz[1:]], nc_l, 15, False)
    aci_w, aci_n = pack_tokens(aci_v, aci_l, NW_BLOCK)
    acp_v, acp_l = block_tokens(acz[..., zz], nc_l, 16, False)
    acp_w, acp_n = pack_tokens(acp_v, acp_l, NW_BLOCK)
    # per-block quadrant index (acz block order by*4+bx)
    bq = np.asarray([(bx >= 2) + 2 * (by >= 2)
                     for by in range(4) for bx in range(4)], np.int32)
    quad_gate = jnp.take_along_axis(
        quad, jnp.broadcast_to(jnp.asarray(bq), (mb_h, mb_w, 16)), -1)
    gi = ii[..., None] * cbp_luma_i[..., None]
    gp = (1 - ii[..., None]) * coded[..., None] * quad_gate
    ac_w = (aci_w * gi[..., None].astype(jnp.uint32)
            + acp_w * gp[..., None].astype(jnp.uint32))
    ac_n = aci_n * gi + acp_n * gp
    ac_w = ac_w[:, :, jnp.asarray(_LUMA_SCAN)]
    ac_n = ac_n[:, :, jnp.asarray(_LUMA_SCAN)]

    cdc_v, cdc_l = block_tokens(czdc, jnp.zeros_like(czdc[..., 0]),
                                4, True)
    cdc_w, cdc_n = pack_tokens(cdc_v, cdc_l, NW_BLOCK)
    gate_c = (cbp_chroma >= 1)[..., None]
    cdc_w = cdc_w * gate_c[..., None].astype(jnp.uint32)
    cdc_n = cdc_n * gate_c

    nc_c = jnp.stack([nc_cb, nc_cr], 2)
    cac_v, cac_l = block_tokens(cacz[..., zz[1:]], nc_c, 15, False)
    cac_w, cac_n = pack_tokens(cac_v, cac_l, NW_BLOCK)
    gate_a = (cbp_chroma == 2)[..., None, None]
    cac_w = cac_w * gate_a[..., None].astype(jnp.uint32)
    cac_n = cac_n * gate_a
    cac_w = cac_w.reshape(mb_h, mb_w, 8, NW_BLOCK)
    cac_n = cac_n.reshape(mb_h, mb_w, 8)

    pieces_w = jnp.concatenate(
        [hdr_w[:, :, None], dc_w[:, :, None], ac_w, cdc_w, cac_w], 2)
    pieces_n = jnp.concatenate(
        [hdr_n[:, :, None], dc_n[:, :, None], ac_n, cdc_n, cac_n], 2)
    # skipped MBs contribute nothing at all
    cg = coded[..., None]
    words, nbits = concat_pieces(pieces_w * cg[..., None],
                                 pieces_n * cg, nw_mb)
    return words, nbits * coded


# --------------------------------------------------------- host assembly ----


def assemble_slices_from_bits(words: np.ndarray, nbits: np.ndarray,
                              header_fn, tail_fn=None) -> list[bytes]:
    """Host: one NAL per MB row from device-packed MB bitstrings.
    ``header_fn(mby) -> _BitWriter`` writes the slice header;
    ``tail_fn(mby) -> _BitWriter | None`` optionally appends
    end-of-slice syntax (the P slice's trailing skip run).  Pure
    numpy bit moves — no VLC work."""
    from opencv_opencl_tpu.io.h264_pcm import _escape

    mb_h, mb_w, nw = words.shape
    nals = []
    for mby in range(mb_h):
        w = header_fn(mby)
        head = np.asarray(w._bits, np.uint8)
        nb = np.asarray(nbits[mby])
        # unpack only the words this row actually uses; device words
        # are MSB-first u32, so big-endian bytes unpack in order and
        # row[mask] flattens in C order == the concatenation of every
        # MB's first nbits bits
        mw = (int(nb.max(initial=0)) + 31) >> 5
        rowbits = np.unpackbits(
            np.ascontiguousarray(words[mby, :, :mw]).astype(">u4")
            .view(np.uint8).reshape(mb_w, mw * 4), axis=-1)
        mask = np.arange(mw * 32)[None, :] < nb[:, None]
        segs = [head, rowbits[mask]]
        if tail_fn is not None:
            tw = tail_fn(mby)
            if tw is not None:
                segs.append(np.asarray(tw._bits, np.uint8))
        bits = np.concatenate(segs)
        # rbsp trailing: stop bit + zero pad to a byte
        n = bits.size + 1
        pad = (-n) % 8
        bits = np.concatenate(
            [bits, np.ones(1, np.uint8), np.zeros(pad, np.uint8)])
        nals.append(bytes(_escape(np.packbits(bits))))
    return nals
