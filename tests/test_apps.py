"""CLI apps: end-to-end runs on tiny inputs + reference-format checks."""

import os
import subprocess
import sys

import numpy as np
import pytest

from opencv_opencl_tpu.apps import clahe_image, histeq_image, parity_bench, relay
from opencv_opencl_tpu.apps._cli import parse_kv_args


class TestCliParser:
    def test_eq_and_space_forms(self):
        opts, pos = parse_kv_args(
            ["--codec=h265", "--bitrate", "5000", "file.mp4"],
            {"codec": str, "bitrate": int},
        )
        assert opts == {"codec": "h265", "bitrate": 5000}
        assert pos == ["file.mp4"]

    def test_bool_flags(self):
        opts, _ = parse_kv_args(
            ["--loop", "--udp-only=false"], {"loop": bool, "udp-only": bool}
        )
        assert opts == {"loop": True, "udp-only": False}

    def test_unknown_arg_ignored(self, capsys):
        opts, _ = parse_kv_args(["--nope=1"], {"input": str})
        assert opts == {}
        assert "ignoring unknown arg" in capsys.readouterr().err

    def test_bad_value_warned(self, capsys):
        opts, _ = parse_kv_args(["--bitrate=abc"], {"bitrate": int})
        assert "bitrate" not in opts


@pytest.fixture
def small_png(tmp_path, rng):
    import cv2

    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    p = str(tmp_path / "small.png")
    cv2.imwrite(p, img)
    return p


def test_clahe_image_output_naming():
    assert clahe_image.output_name("/a/b/2K.jpg", 2.0, 8) == "2K2-8x8.jpg"
    assert clahe_image.output_name("x.png", 2.5, 4) == "x2p5-4x4.png"
    assert clahe_image.output_name("noext", 3.0, 4) == "noext3-4x4.jpg"


def test_histeq_image_app(small_png, tmp_path, capsys):
    out = str(tmp_path / "out.png")
    rc = histeq_image.run([small_png, out])
    assert rc == 0
    assert os.path.exists(out)
    text = capsys.readouterr().out
    assert "PERFORMANCE BREAKDOWN" in text
    assert "Potential FPS" in text


def test_histeq_image_usage(capsys):
    assert histeq_image.run([]) == -1


def test_clahe_image_app(small_png, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = clahe_image.run([f"--input={small_png}", "--clipLimit=2.0", "--tile=4"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "CLAHE_apply_time_ms=" in text
    assert os.path.exists(str(tmp_path / "small2-4x4.png"))


def test_clahe_image_rejects_bad_params(capsys):
    assert clahe_image.run(["--input=x.png", "--clipLimit=0"]) == 1
    assert clahe_image.run([]) == 1


def test_parity_bench_histeq(small_png, capsys):
    rc = parity_bench.run([f"--input={small_png}", "--op=histeq", "--repeat=2"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "Results match!" in text
    assert "OpenCV histeq time" in text
    assert "device histeq time" in text


def test_parity_bench_clahe(small_png, capsys):
    rc = parity_bench.run(
        [f"--input={small_png}", "--op=clahe", "--clipLimit=2.0",
         "--tile=4", "--repeat=2"]
    )
    assert rc == 0
    assert "Results match!" in capsys.readouterr().out


def test_relay_test_source(capsys):
    rc = relay.run([
        "--width=64", "--height=48", "--fps=30", "--max-frames=8",
        "--batch=2", "--workers=2", "--op=histeq", "--chroma=gray",
        "--status-interval=60",
    ])
    text = capsys.readouterr().out
    assert rc == 0
    assert "relay pipeline started" in text
    assert "(with frame ordering)" in text
    assert "8 frames emitted" in text
    assert "FINAL PERFORMANCE ANALYSIS" in text


def test_clahe_video_app(tmp_path, rng, capsys):
    import cv2

    from opencv_opencl_tpu.apps import clahe_video

    # build a tiny 10-frame video
    vid = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    assert w.isOpened(), "cv2 VideoWriter unavailable"
    for _ in range(10):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()

    out = str(tmp_path / "out.mp4")
    rc = clahe_video.run([
        f"--input={vid}", f"--output={out}", "--resolution=64x48",
        "--clipLimit=2.0", "--tile=4", "--max-frames=10",
        "--detailed-timing",
    ])
    text = capsys.readouterr().out
    assert rc == 0
    assert "TIMING MEASUREMENT STARTED" in text
    assert "FINAL PERFORMANCE ANALYSIS" in text
    assert "MP4 saved" in text
    assert os.path.exists(out)


def test_clahe_video_udp_tee(tmp_path, rng, capsys):
    """The reference's tee: RTP/UDP + mp4 simultaneously
    (CLAHECompare.cpp:438-483) — receiver decodes frames while the file
    sink records."""
    import threading

    import cv2

    from opencv_opencl_tpu.apps import clahe_video
    from opencv_opencl_tpu.io.rtp import RtpUdpReceiver

    vid = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    assert w.isOpened(), "cv2 VideoWriter unavailable"
    for _ in range(8):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()

    rx = RtpUdpReceiver(port=0, kind="raw", frame_shape=(72, 64),
                        timeout=20.0)
    got = []

    def drain():
        try:
            while len(got) < 4:
                got.append(rx.recv_frame())
        except (TimeoutError, OSError):
            pass

    t = threading.Thread(target=drain)
    t.start()
    out = str(tmp_path / "out.mp4")
    rc = clahe_video.run([
        f"--input={vid}", f"--output={out}",
        f"--udp=127.0.0.1:{rx.port}", "--udp-kind=raw",
        "--resolution=64x48", "--tile=4", "--max-frames=8",
    ])
    t.join(timeout=25)
    rx.close()
    text = capsys.readouterr().out
    assert rc == 0
    assert "rtp+raw://127.0.0.1" in text  # scheme matches relay's --sink
    assert "MP4 saved" in text
    assert os.path.exists(out)
    assert len(got) >= 1            # frames really crossed the wire
    assert got[0].shape == (72, 64)  # NV12 rows of a 64x48 frame


def _handshake(extra_args, port, room, expect_kinds):
    """sender app end-to-end in signaling-only mode: self-served room, a
    viewer joins, a REAL generated offer flows, the viewer parses it and
    answers with a real mirrored SDP (io.sdp), the sender parses that."""
    import threading
    import time as _time

    from opencv_opencl_tpu.apps import sender
    from opencv_opencl_tpu.io import sdp
    from opencv_opencl_tpu.io.signaling import SignalingClient

    rc = {}

    def run_sender():
        rc["rc"] = sender.run([
            f"--ws=ws://127.0.0.1:{port}", f"--room={room}",
            "--serve-signaling", "--signaling-only", "--duration=4",
            *extra_args,
        ])

    t = threading.Thread(target=run_sender)
    t.start()
    _time.sleep(1.0)  # let the server + sender come up

    got = {"offer": None}

    def on_offer(sdp_text, frm):
        got["offer"] = sdp_text
        sess = sdp.parse_sdp(sdp_text)
        viewer.send_answer(sdp.build_answer(sess))

    viewer = SignalingClient(
        f"ws://127.0.0.1:{port}", room=room, client_type="viewer",
        on_offer=on_offer,
    ).start()
    assert viewer.wait_connected(10)
    deadline = _time.time() + 5
    while got["offer"] is None and _time.time() < deadline:
        _time.sleep(0.05)
    viewer.stop()
    t.join(timeout=15)
    assert rc.get("rc") == 0
    # the offer must be real, parseable SDP with the configured media set
    sess = sdp.parse_sdp(got["offer"])
    assert [m.kind for m in sess.medias] == expect_kinds
    for m in sess.medias:
        assert m.encoding_name and m.clock_rate > 0
        assert m.direction == "sendonly"
        assert m.mid
    assert sess.ice_ufrag and sess.ice_pwd and sess.fingerprint
    return sess


def test_sender_full_handshake(capsys):
    sess = _handshake([], 18099, "t1", ["video"])
    assert sess.medias[0].encoding_name == "H264"
    out = capsys.readouterr().out
    assert "Viewer joined" in out
    assert "Received answer (1 m-line(s): video)" in out


def test_sender_handshake_with_audio(capsys):
    """--audio: silent Opus track rides the same offer (vadcamera.cpp)."""
    sess = _handshake(["--audio"], 18098, "t2", ["video", "audio"])
    assert sess.medias[1].encoding_name == "OPUS"
    assert sess.medias[1].channels == 2
    out = capsys.readouterr().out
    assert "Received answer (2 m-line(s): video+audio)" in out
    assert "audiotestsrc wave=silence" in out  # pipeline embeds the branch


def test_sender_test_source_two_track(capsys):
    """--test-source: the vad.cpp VP8+Opus two-track test sender."""
    sess = _handshake(["--test-source"], 18097, "t3", ["video", "audio"])
    assert sess.medias[0].encoding_name == "VP8"
    out = capsys.readouterr().out
    assert "videotestsrc is-live=true" in out
    assert "opusenc" in out


def test_relay_ref_frame_streaming(capsys):
    """relay --ref-frame: the streaming CLAHE mode end-to-end."""
    from opencv_opencl_tpu.apps import relay

    rc = relay.run([
        "--source=test", "--width=128", "--height=96", "--max-frames=12",
        "--batch=4", "--op=clahe", "--ref-frame", "--chroma=passthrough",
    ])
    assert rc == 0
    assert "relay pipeline started" in capsys.readouterr().out


def test_relay_rejects_bad_rtcp_schedule(capsys):
    from opencv_opencl_tpu.apps import relay

    rc = relay.run(["--source=test", "--width=64", "--height=32",
                    "--sink=rtp://127.0.0.1:59000",
                    "--rtcp-schedule=cron"])
    assert rc == 2


def test_relay_rejects_bad_mesh(capsys):
    from opencv_opencl_tpu.apps import relay

    for bad in ("8", "axb", "0x2"):
        rc = relay.run(["--source=test", "--width=64", "--height=32",
                        f"--mesh={bad}"])
        assert rc == 2, bad


def test_multi_relay_mesh(capsys):
    """multi_relay --mesh: N streams served by a sharded pipeline on the
    virtual 8-device mesh."""
    from opencv_opencl_tpu.apps import multi_relay

    rc = multi_relay.run([
        "--streams=2", "--width=128", "--height=64", "--fps=30",
        "--max-frames=6", "--batch=2", "--op=clahe", "--mesh=2x2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Sharded over mesh" in out
    # frames must actually flow: a sharded-pipeline regression swallowed
    # as per-batch processing errors would still print the banner
    import re

    m = re.search(r"Shutdown: (\d+) frames across", out)
    assert m and int(m.group(1)) > 0


def test_multi_relay_per_stream_adaptive_rate(capsys):
    """Per-stream congestion control: a lossy stream backs off while its
    neighbor keeps full rate."""
    import threading

    from opencv_opencl_tpu.apps import multi_relay
    from opencv_opencl_tpu.io import rtp

    rxs = [rtp.RtpUdpReceiver(kind="jpeg", port=47700 + 2 * i,
                              timeout=30.0) for i in range(2)]
    # receiver 1 pretends to see loss: force its RR fraction_lost high
    # by monkey-patching its stats' interval fraction
    orig = rxs[1].rtcp.stats.fraction_lost_interval
    rxs[1].rtcp.stats.fraction_lost_interval = lambda: 128  # 50% loss
    rxs[1].rtcp.interval = 0.0  # report immediately
    rxs[0].rtcp.interval = 0.0
    stop = threading.Event()
    def drain(i):
        while not stop.is_set():
            try:
                rxs[i].recv_frame()
            except (TimeoutError, OSError):
                return
    ts = [threading.Thread(target=drain, args=(i,), daemon=True)
          for i in range(2)]
    [t.start() for t in ts]
    # the backoff line needs a full RTCP round trip to land within the
    # frame budget; under machine load the receiver threads can starve,
    # so retry the (idempotent) relay run once before calling it a bug
    out = ""
    for _attempt in range(2):
        rc = multi_relay.run([
            "--streams=2", "--width=128", "--height=96", "--fps=30",
            "--max-frames=40", "--batch=2", "--op=histeq",
            "--sink=rtp://127.0.0.1:47700", "--adaptive-rate",
            "--max-rate=60",
        ])
        assert rc == 0
        out = capsys.readouterr().out
        if "[adaptive-rate] stream 1 loss=128/256" in out:
            break
    stop.set()
    rxs[1].rtcp.stats.fraction_lost_interval = orig
    [r.close() for r in rxs]
    [t.join(timeout=5) for t in ts]
    # the lossy stream (1) backed off; the clean stream (0) did not
    assert "[adaptive-rate] stream 1 loss=128/256" in out
    # per-stream isolation: the clean stream kept (at least) the backed-
    # off stream's rate — asserted on emissions, robust to real loss
    import re

    pairs = re.findall(r"#(\d)=(\d+)/", out)
    emitted = {int(a): int(b) for a, b in pairs}
    assert emitted[0] >= emitted[1]


def test_multi_relay_static_max_rate(capsys):
    """--max-rate without --adaptive-rate applies a static per-stream
    cap (parity with relay)."""
    from opencv_opencl_tpu.apps import multi_relay

    rc = multi_relay.run([
        "--streams=2", "--width=64", "--height=32", "--fps=60",
        "--max-frames=20", "--batch=2", "--op=histeq", "--max-rate=5",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    import re

    m = re.search(r"Shutdown: (\d+) frames across", out)
    # 40 frames submitted at a 5 fps/stream cap: some must be shed
    assert m and 1 <= int(m.group(1)) < 40


def test_multi_relay_rejects_nonpositive_max_rate(capsys):
    from opencv_opencl_tpu.apps import multi_relay

    rc = multi_relay.run(["--streams=1", "--max-rate=0",
                          "--adaptive-rate"])
    assert rc == 2


def test_multi_relay_all_serving_features_compose(capsys):
    """--mesh + --priorities + --adaptive-rate together: the full
    serving configuration runs end-to-end on the virtual mesh."""
    import threading

    from opencv_opencl_tpu.apps import multi_relay
    from opencv_opencl_tpu.io import rtp

    rxs = [rtp.RtpUdpReceiver(kind="jpeg", port=47900 + 2 * i,
                              timeout=30.0) for i in range(2)]
    stop = threading.Event()
    def drain(i):
        while not stop.is_set():
            try:
                rxs[i].recv_frame()
            except (TimeoutError, OSError):
                return
    ts = [threading.Thread(target=drain, args=(i,), daemon=True)
          for i in range(2)]
    [t.start() for t in ts]
    rc = multi_relay.run([
        "--streams=2", "--width=128", "--height=64", "--fps=30",
        "--max-frames=10", "--batch=2", "--op=clahe", "--mesh=2x2",
        "--sink=rtp://127.0.0.1:47900", "--adaptive-rate",
        "--priorities=1,2",
    ])
    stop.set()
    [r.close() for r in rxs]
    [t.join(timeout=5) for t in ts]
    assert rc == 0
    out = capsys.readouterr().out
    assert "Sharded over mesh" in out
    import re

    m = re.search(r"Shutdown: (\d+) frames across", out)
    assert m and int(m.group(1)) > 0


def test_sigterm_translates_to_clean_shutdown():
    """SIGTERM (systemd/k8s stop) takes the same drain path as Ctrl-C."""
    import os
    import signal

    from opencv_opencl_tpu.apps._cli import install_sigterm_handler

    prev = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        install_sigterm_handler()
        import pytest as _pytest

        with _pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
            signal.sigtimedwait([], 0.2) if hasattr(signal, "sigtimedwait") \
                else None
        # custom handlers are respected (not displaced)
        sentinel = lambda s, f: None
        signal.signal(signal.SIGTERM, sentinel)
        install_sigterm_handler()
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_clahe_video_encoded_udp_tee(tmp_path, rng, capsys):
    """The reference's tee actually ENCODED before the RTP leg
    (CLAHECompare.cpp:438-483: appsrc -> omx enc -> tee): --udp-kind=h264
    runs the encoded leg through the pluggable encoder boundary while
    the mp4 file sink records alongside."""
    import threading

    import cv2

    from opencv_opencl_tpu.apps import clahe_video
    from opencv_opencl_tpu.io.rtp_h26x import H26xRtpReceiver

    vid = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    assert w.isOpened(), "cv2 VideoWriter unavailable"
    for _ in range(8):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()

    rx = H26xRtpReceiver(codec="h264", timeout=30.0)
    aus = []

    def drain():
        for _ in range(3):
            au = rx.recv_access_unit()
            if au is not None:
                aus.append(au)

    t = threading.Thread(target=drain)
    t.start()
    out = str(tmp_path / "out.mp4")
    rc = clahe_video.run([
        f"--input={vid}", f"--output={out}",
        f"--udp=127.0.0.1:{rx.port}", "--udp-kind=h264", "--encoder=pcm",
        "--resolution=64x48", "--tile=4", "--max-frames=8",
    ])
    t.join(timeout=40)
    rx.close()
    text = capsys.readouterr().out
    assert rc == 0
    assert "rtp+h264://127.0.0.1" in text
    assert "MP4 saved" in text
    assert os.path.exists(out)
    assert len(aus) == 3
    # the RTP leg carries a decodable H.264 stream
    es = tmp_path / "leg.h264"
    es.write_bytes(b"".join(aus))
    cap = cv2.VideoCapture(str(es))
    ok, frame = cap.read()
    assert ok and frame.shape[:2] == (48, 64)
    cap.release()
