"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --devices=4  # four cards: the mesh phase only

NV12 frames -> equalizeHist or CLAHE on Y -> NV12 out, and the fused
CLAHE + H.264 GOP encode -> RTP, driven through the entry points a user
calls (``models.enhancer``, ``apps.relay``, ``io.h264_inter``) at 1920x1080
and 3840x2160.  Every output is checked: enhanced frames against the numpy
golden models in ``core/golden.py``, histograms against ``np.bincount``,
H.264 access units byte for byte against the Python oracle encoder.

Phases run in order and any failure raises, so the exit code is non-zero.
Without a GPU the script stops before any phase.  It runs in one JAX
process.  Its last line of output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

QP = 30
HD = (1920, 1080)                      # the upstream live relay
SIZES = (HD, (3840, 2160))             # ... and the 4K60 design target
CLIP, GRID = 2.0, (8, 8)
SEED = 0


def _phase(name):
    print(f"\n== {name}", flush=True)
    return time.perf_counter()


def _done(name, t0):
    print(f"-- {name} passed in {time.perf_counter() - t0:.1f} s", flush=True)


def _median_ms(fn, *args, reps=10):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2] * 1e3


def _test_frames(w, h, n):
    from opencv_opencl_tpu.core.frames import FrameSpec
    from opencv_opencl_tpu.io.videofile import TestSource

    return np.stack(list(TestSource(FrameSpec(width=w, height=h),
                                    num_frames=n, seed=SEED)))


def _pan_frames(w, h, n):
    """NV12 frames of a smooth band-limited scene translated one pixel
    per frame along both axes: content on which motion search has a true
    answer."""
    ph = np.random.default_rng(SEED).uniform(0, 6.28, 4)
    m = np.arange(h + n, dtype=np.float64)[:, None]
    v = np.arange(w + n, dtype=np.float64)[None, :]
    scene = (128 + 50 * np.sin(2 * np.pi * m / 17.3 + ph[0])
             * np.cos(2 * np.pi * v / 23.7 + ph[1])
             + 40 * np.sin(2 * np.pi * (m + v) / 31.9 + ph[2])
             + 25 * np.cos(2 * np.pi * (2 * m - v) / 27.1 + ph[3]))
    scene = np.clip(scene, 0, 255).astype(np.uint8)
    uv = np.full((h // 2, w), 128, np.uint8)
    return np.stack([np.concatenate([scene[i:i + h, i:i + w], uv])
                     for i in range(n)])


def _golden_y(op, y):
    from opencv_opencl_tpu.core import golden

    if op == "histeq":
        return golden.equalize_hist(y)
    return golden.clahe(y, CLIP, GRID)


def _check_y(label, out, ref):
    """The reference's bar: +-1 LSB on under 1% of pixels; print the
    exact count so any non-zero difference is on record."""
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((d > 0).sum())
    print(f"{label}: max|diff| {int(d.max())}, pixels differing {ndiff} "
          f"of {d.size}", flush=True)
    if d.max() > 1 or ndiff >= 0.01 * d.size:
        raise AssertionError(f"{label}: outside the +-1 LSB / 1% bar")
    return ndiff


def phase_device():
    import jax

    from opencv_opencl_tpu.utils.compile_cache import enable_compile_cache

    t0 = _phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    cache = enable_compile_cache()
    dev = jax.devices()
    print(f"jax {jax.__version__}, backend {jax.default_backend()}, "
          f"device_kind {dev[0].device_kind}, count {len(dev)}, "
          f"compile cache {cache}", flush=True)
    assert jax.default_backend() == "gpu", jax.default_backend()
    _done("device", t0)
    return smi


def phase_kernels():
    """The radix histogram kernel, compiled for the card, against
    np.bincount at real widths: CLAHE tiles and whole frames."""
    import jax.numpy as jnp
    import pytest

    from opencv_opencl_tpu.ops.pallas import radix_hist

    t0 = _phase("kernels")
    for w, h in SIZES:
        frames = _test_frames(w, h, 4)[:, :h]
        for ty, tx in (GRID, (1, 1)):
            th, tw = h // ty, w // tx
            got = np.asarray(radix_hist.tile_histograms(
                jnp.asarray(frames), ty, tx, th, tw))
            ref = np.stack([[np.bincount(
                f[a * th:(a + 1) * th, b * tw:(b + 1) * tw].ravel(),
                minlength=256) for a in range(ty) for b in range(tx)]
                for f in frames])
            assert np.array_equal(got, ref), (w, h, ty, tx)
            print(f"radix_tile_hist {w}x{h} grid {tx}x{ty}: exact", flush=True)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(
                          __file__)), "tests", "test_gpu.py")])
    assert rc == 0, f"gpu-marked tests failed (pytest rc {rc})"
    _done("kernels", t0)


def phase_enhance():
    import jax.numpy as jnp

    from opencv_opencl_tpu.core import golden
    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.models.enhancer import (EnhancerConfig,
                                                   build_enhance_fn)
    from opencv_opencl_tpu.ops.clahe import clahe

    t0 = _phase("enhance step")
    timings = {}
    lsb = {}
    for w, h in SIZES:
        spec = FrameSpec(width=w, height=h)
        x = _test_frames(w, h, 4)
        xd = jnp.asarray(x)
        for op in ("histeq", "clahe"):
            cfg = EnhancerConfig(op=op, clip_limit=CLIP, tile_grid=GRID,
                                 chroma=ChromaPolicy.PASSTHROUGH)
            fn = build_enhance_fn(cfg, spec, donate=False)
            if op == "clahe":
                print(f"memory_analysis clahe {w}x{h} batch 4: "
                      f"{fn.lower(xd).compile().memory_analysis()}")
            out = np.asarray(fn(xd))
            assert out.shape == x.shape and out.dtype == np.uint8
            assert np.array_equal(out[:, h:], x[:, h:]), "chroma passthrough"
            ref = np.stack([_golden_y(op, f[:h]) for f in x])
            lsb[f"{op} {w}x{h}"] = _check_y(f"{op} {w}x{h}", out[:, :h], ref)
            if op == "histeq":
                assert lsb[f"{op} {w}x{h}"] == 0, "equalizeHist must be exact"
            ms = _median_ms(fn, xd) / 4
            timings[f"{op} {w}x{h}"] = ms
            print(f"{op} {w}x{h} enhance step: {ms:.4f} ms/frame "
                  f"(batch 4, block_until_ready)", flush=True)
    w, h = HD
    y = np.ascontiguousarray(_test_frames(w, h, 1)[0, :h - 1, :w - 1])
    out = np.asarray(clahe(jnp.asarray(y), CLIP, GRID))
    lsb[f"clahe {w - 1}x{h - 1}"] = _check_y(
        f"clahe {w - 1}x{h - 1}", out, golden.clahe(y, CLIP, GRID))
    _done("enhance step", t0)
    return timings, lsb


def _relay_golden_ref_frame(frames, h):
    """``--ref-frame`` semantics (models/enhancer.build_streaming_clahe_fn):
    frame i is mapped with the tile LUTs of frame i-1; frame 0 with the
    LUTs of the uniform stream-start histograms."""
    from opencv_opencl_tpu.core import golden
    from opencv_opencl_tpu.models.enhancer import initial_hists
    from opencv_opencl_tpu.ops.clahe import make_clahe_plan

    w = frames.shape[2]
    plan = make_clahe_plan(h, w, CLIP, GRID)
    scale = np.float32(255.0) / np.float32(plan.tile_area)
    luts0 = np.stack([
        np.clip(np.rint(np.cumsum(golden._clip_histogram(hist, plan.clip))
                        .astype(np.float32) * scale), 0, 255)
        .astype(np.uint8) for hist in np.asarray(initial_hists(plan))
    ]).reshape(plan.tiles_y, plan.tiles_x, 256)
    out, luts = [], luts0
    for f in frames:
        y = f[:h]
        out.append(golden.clahe_apply_luts(y, luts, plan.tile_h, plan.tile_w))
        luts = golden.clahe_luts(y, CLIP, GRID)[0]
    return np.stack(out)


def phase_relay():
    from opencv_opencl_tpu.apps import relay

    t0 = _phase("relay")
    (w, h), n = HD, 32
    frames = _test_frames(w, h, n)
    with tempfile.TemporaryDirectory() as tmp:
        for ref_frame in (False, True):
            sink = os.path.join(tmp, f"out_{int(ref_frame)}.nv12")
            # paced input: the relay's leaky queue drops frames that
            # arrive faster than they are processed, and this check
            # needs every frame
            argv = ["--source=test", f"--width={w}", f"--height={h}",
                    "--op=clahe", "--chroma=passthrough", "--realtime",
                    "--fps=15", f"--max-frames={n}", "--status-interval=600",
                    f"--sink={sink}"]
            if ref_frame:
                argv.append("--ref-frame")
            assert relay.run(argv) == 0
            got = np.fromfile(sink, np.uint8)
            assert got.size == frames.size, "relay dropped frames"
            got = got.reshape(frames.shape)
            assert np.array_equal(got[:, h:], frames[:, h:])
            if ref_frame:
                ref = _relay_golden_ref_frame(frames, h)
            else:
                ref = np.stack([_golden_y("clahe", f[:h]) for f in frames])
            _check_y(f"relay clahe{' --ref-frame' if ref_frame else ''} "
                     f"{n} frames", got[:, :h], ref)
    _done("relay", t0)


class _UdpCounter:
    """Counts RTP packets arriving on a local UDP port."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.packets = 0
        self.rtp_v2 = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            self.packets += 1
            self.rtp_v2 += int(len(data) >= 12 and data[0] >> 6 == 2)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        assert not self._thread.is_alive()
        self.sock.close()


ENC_CONFIGS = (("search=8", dict(search=8)),
               ("search=4 quarterpel parts refs=2",
                dict(search=4, quarterpel=True, parts=True, refs=2)))


def _fused_fn(enc, w, h):
    """The fused CLAHE + GOP program for TpuGopEncoder ``enc``, built as
    ``apps.relay --fused-encode`` builds it."""
    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.models.enhancer import EnhancerConfig
    from opencv_opencl_tpu.models.fused_encode import build_enhance_gop_fn

    cfg = EnhancerConfig(op="clahe", clip_limit=CLIP, tile_grid=GRID,
                         chroma=ChromaPolicy.PASSTHROUGH)
    return build_enhance_gop_fn(
        cfg, FrameSpec(width=w, height=h), enc.gop, search=enc.search,
        subpel=enc.subpel, refs=enc.refs, deblock=enc.deblock, gdr=enc.gdr,
        bitpack=(enc._nw_mb if enc._bitpack else 0), parts=enc.parts)


def _fused_stream(enc, fn, frames, batch=1):
    """Per-frame access units of ``frames`` through the fused CLAHE + GOP
    program ``fn``, ``batch`` frames per dispatch, the reconstruction
    carried on the device between dispatches as the relay does."""
    import jax.numpy as jnp

    recon = enc.initial_recon()
    aus = []
    for i in range(0, len(frames), batch):
        packed, *recon = fn(jnp.asarray(frames[i:i + batch]),
                            jnp.int32(enc.qp), i, *recon)
        aus += [enc.encode_from_packed(p) for p in np.asarray(packed)]
    return aus


def _fused_p_timing(enc, fn, frame, reps=10):
    """Device ms of one fused P-frame dispatch (compiled, median of
    ``reps``) and host entropy ms of its access unit."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(frame[None])
    recons = [enc.initial_recon() for _ in range(reps + 1)]  # donated
    ts = []
    for recon in recons:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(x, jnp.int32(enc.qp), 1, *recon))
        ts.append(time.perf_counter() - t0)
    packed = np.asarray(out[0])[0]
    t0 = time.perf_counter()
    enc.encode_from_packed(packed)
    return sorted(ts[1:])[reps // 2] * 1e3, (time.perf_counter() - t0) * 1e3


def _oracle_init():
    # the oracle encoder is host code: keep its process off the card
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _oracle_stream(w, h, kw, frames):
    """Access units of the Python oracle encoder (io/h264_inter)."""
    from opencv_opencl_tpu.io.h264_inter import GopCavlcEncoder

    oracle = GopCavlcEncoder(w, h, qp=QP, gop=30, slices=-(-h // 16), **kw)
    return [au for f in frames for au in oracle.encode(f)]


def phase_encoder():
    """The relay's fused CLAHE + encode path to RTP, then its streams byte
    for byte against the oracle encoder.  The oracles run in CPU-only
    worker processes and the second program compiles in a thread, both
    while the relay compiles and runs its own."""
    import jax
    import jax.numpy as jnp

    from opencv_opencl_tpu.apps import relay
    from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder

    t0 = _phase("encoder")
    w, h = HD
    frames = _pan_frames(w, h, 4)
    enhanced = frames.copy()
    enhanced[:, :h] = np.stack([_golden_y("clahe", f[:h]) for f in frames])
    encs = {label: TpuGopEncoder(w, h, qp=QP, gop=30, **kw)
            for label, kw in ENC_CONFIGS}
    fns = {label: _fused_fn(enc, w, h) for label, enc in encs.items()}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(ENC_CONFIGS), mp_context=spawn,
                             initializer=_oracle_init) as pool, \
            ThreadPoolExecutor(1) as compiler:
        oracles = {label: pool.submit(_oracle_stream, w, h, kw, enhanced)
                   for label, kw in ENC_CONFIGS}
        label = ENC_CONFIGS[1][0]
        warm = compiler.submit(lambda enc, fn: jax.block_until_ready(fn(
            jnp.asarray(frames[:1]), jnp.int32(QP), 0,
            *enc.initial_recon())), encs[label], fns[label])

        rx = _UdpCounter()
        try:
            # --batch=1: the GOP chain never pads a batch, so each distinct
            # partial batch size would compile a program of its own
            rc = relay.run([
                "--source=test", f"--width={w}", f"--height={h}",
                "--op=clahe", "--chroma=passthrough", "--max-frames=8",
                "--batch=1", "--status-interval=600", "--fused-encode",
                f"--sink=rtp+h264://127.0.0.1:{rx.port}",
                "--encoder=tpu:gop=30:search=8"])
            time.sleep(0.5)
        finally:
            rx.close()
        assert rc == 0
        print(f"relay --fused-encode: {rx.packets} UDP packets received, "
              f"{rx.rtp_v2} RTP v2", flush=True)
        assert rx.packets > 0 and rx.rtp_v2 == rx.packets
        warm.result()

        timings = {}
        for label, _ in ENC_CONFIGS:
            enc, fn = encs[label], fns[label]
            got = [au for f_aus in _fused_stream(enc, fn, frames)
                   for au in f_aus]
            ms, host_ms = _fused_p_timing(enc, fn, frames[1])
            want = oracles[label].result()
            print(f"fused CLAHE+encode {w}x{h} {label}: {len(got)} AUs, "
                  f"{sum(map(len, got))} bytes, byte-identical "
                  f"{got == want}; P frame: device {ms:.3f} ms, host "
                  f"entropy {host_ms:.1f} ms", flush=True)
            assert got == want, f"{label}: stream differs from the oracle"
            timings[label] = ms
    _done("encoder", t0)
    return timings


def phase_mesh(n):
    """Sharded enhancement and both mesh encoders on ``n`` cards,
    against one card."""
    import jax
    import jax.numpy as jnp

    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
    from opencv_opencl_tpu.models.enhancer import (EnhancerConfig,
                                                   build_enhance_fn)
    from opencv_opencl_tpu.parallel import build_sharded_pipeline, make_mesh
    from opencv_opencl_tpu.parallel.sharded_encode import (
        BandedTpuGopEncoder, build_mesh_gop_fn, pad_batch_for_mesh)

    t0 = _phase(f"mesh ({n} devices)")
    assert len(jax.devices()) >= n, f"need {n} devices"

    # Both mesh encoders against the one-card fused CLAHE + GOP path (the
    # sequential TpuGopEncoder stream).  Their programs take minutes to
    # compile with the unrolled level scans, so they compile in threads
    # while the sharded enhancement is checked below.
    (we, he), gop = HD, 30
    cfg = EnhancerConfig(op="clahe", clip_limit=CLIP, tile_grid=GRID,
                         chroma=ChromaPolicy.PASSTHROUGH)
    espec = FrameSpec(width=we, height=he)
    frames = _pan_frames(we, he, n * gop)
    emesh = make_mesh(n)

    def mesh_gop():
        fn, sharding, unit = build_mesh_gop_fn(cfg, espec, gop, emesh,
                                               search=8)
        padded, real = pad_batch_for_mesh(frames, n, unit)
        packed = np.asarray(fn(jax.device_put(padded, sharding),
                               jnp.int32(QP)))
        enc = TpuGopEncoder(we, he, qp=QP, gop=gop, search=8)
        return [enc.encode_from_packed(p) for p in packed[:real]]

    def banded():
        enhanced = np.asarray(build_enhance_fn(cfg, espec, donate=False)(
            frames[:4]))
        enc = BandedTpuGopEncoder(we, he, emesh, qp=QP, gop=gop, search=8)
        return [enc.encode(f) for f in enhanced]

    def one_card():
        enc = TpuGopEncoder(we, he, qp=QP, gop=gop, search=8)
        return _fused_stream(enc, _fused_fn(enc, we, he), frames)

    with ThreadPoolExecutor(3) as ex:
        futures = [ex.submit(f) for f in (mesh_gop, banded, one_card)]

        w, h = SIZES[-1]
        spec = FrameSpec(width=w, height=h)
        x = _test_frames(w, h, 8)
        shapes = ([(n, 1), (2, n // 2), (1, n)] if n == 4
                  else [(n, 1), (1, n)])
        for op in ("histeq", "clahe"):
            ecfg = EnhancerConfig(op=op, clip_limit=CLIP, tile_grid=GRID,
                                  chroma=ChromaPolicy.PASSTHROUGH)
            single = np.asarray(build_enhance_fn(ecfg, spec, donate=False)(
                jnp.asarray(x)))
            for shape in shapes:
                mesh = make_mesh(shape=shape)
                fn, sharding = build_sharded_pipeline(ecfg, h, w, mesh)
                y_out, uv_out = fn(jax.device_put(x[:, :h], sharding),
                                   jnp.asarray(x[:, h:]))
                same = (np.array_equal(np.asarray(y_out), single[:, :h])
                        and np.array_equal(np.asarray(uv_out),
                                           single[:, h:]))
                print(f"sharded {op} {w}x{h} batch 8 mesh {shape}: "
                      f"identical to one card {same}", flush=True)
                assert same

        got_mesh, got_banded, want = (f.result() for f in futures)
    same = got_mesh == want
    print(f"GOP-per-device mesh encode {we}x{he}, {len(want)} frames over "
          f"{n} devices: byte-identical to one card {same}", flush=True)
    assert same
    same = got_banded == want[:4]
    print(f"banded encode {we}x{he} over {n} devices, 4 frames: "
          f"byte-identical to one card {same}", flush=True)
    assert same
    _done(f"mesh ({n} devices)", t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the multi-device mesh phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    smi = phase_device()
    if args.devices > 1:
        phase_mesh(args.devices)
    else:
        phase_kernels()
        enh_ms, lsb = phase_enhance()
        phase_relay()
        enc_ms = phase_encoder()
        print(f"\nsummary on {smi}:")
        for k, v in enh_ms.items():
            print(f"  enhance {k}: {v:.4f} ms/frame")
        for k, v in enc_ms.items():
            print(f"  fused CLAHE+encode {HD[0]}x{HD[1]} {k}: "
                  f"{v:.3f} ms/frame")
        print(f"  pixels differing from core/golden: {lsb}")
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
