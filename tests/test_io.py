"""io layer: video sources/sinks, gst pipeline builders, signaling."""

import time

import numpy as np
import pytest

from opencv_opencl_tpu.core.frames import FrameSpec
from opencv_opencl_tpu.io import gst
from opencv_opencl_tpu.io.signaling import SignalingClient, SignalingServer
from opencv_opencl_tpu.io.videofile import FileSink, FileSource, NullSink, TestSource


class TestVideoFile:
    def test_test_source_deterministic(self):
        spec = FrameSpec(width=64, height=48, fps=30)
        a = list(TestSource(spec, num_frames=3, seed=7))
        b = list(TestSource(spec, num_frames=3, seed=7))
        assert len(a) == 3
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
            assert x.shape == (72, 64)

    def test_file_roundtrip(self, tmp_path, rng):
        spec = FrameSpec(width=64, height=48, fps=30)
        path = str(tmp_path / "t.mp4")
        sink = FileSink(path, spec)
        for f in TestSource(spec, num_frames=8):
            sink.write(f)
        sink.close()
        src = FileSource(path)
        frames = list(src)
        src.close()
        assert len(frames) == 8
        assert frames[0].shape == (72, 64)

    def test_file_source_loop(self, tmp_path):
        spec = FrameSpec(width=64, height=48, fps=30)
        path = str(tmp_path / "t.mp4")
        sink = FileSink(path, spec)
        for f in TestSource(spec, num_frames=4):
            sink.write(f)
        sink.close()
        src = FileSource(path, loop=True)
        got = [src.read() for _ in range(10)]
        src.close()
        assert all(f is not None for f in got)
        assert src.loops_done >= 1

    def test_missing_file_raises(self):
        with pytest.raises(IOError):
            FileSource("/nonexistent/x.mp4")


class TestGstBuilders:
    def test_capture_pipeline(self):
        s = gst.capture_pipeline(width=1920, height=1080, fps=60)
        assert "v4l2src" in s and "io-mode=4" in s
        assert "leaky=downstream" in s
        assert "max-buffers=1 drop=true" in s

    def test_emit_pipeline_default(self):
        enc = gst.EncoderConfig(codec="h264", bitrate_kbps=20000)
        s = gst.emit_pipeline(enc)
        assert "omxh264enc" in s and "rtph264pay" in s
        assert "control-rate=low-latency" in s
        assert "qos-dscp=60" in s
        assert "cpb-size=500" in s

    def test_emit_pipeline_tuned(self):
        """The binary-only `improvement` ELF tuning deltas."""
        enc = gst.EncoderConfig(codec="h265")
        s = gst.emit_pipeline(enc, tuned=True)
        assert "mtu=1200" in s
        assert "cpb-size=1000" in s and "initial-delay=500" in s
        assert "buffer-size=100000000" in s
        assert "omxh265enc" in s and "rtph265pay" in s

    def test_file_emit_tee(self):
        enc = gst.EncoderConfig()
        s = gst.file_emit_pipeline(enc, output_file="out.mp4")
        assert "tee name=t" in s and "mp4mux" in s
        s2 = gst.file_emit_pipeline(enc)
        assert "tee" not in s2

    def test_webrtc_pipeline(self):
        enc = gst.EncoderConfig(codec="h264")
        s = gst.webrtc_pipeline(enc)
        assert "webrtcbin" in s
        assert "stun.l.google.com:19302" in s
        assert "profile=baseline" in s

    def test_gst_shell_gated(self):
        if not gst.gst_available():
            with pytest.raises(RuntimeError, match="gst-launch"):
                gst.GstShell("fakesrc ! fakesink").start()


class TestSignaling:
    def test_offer_answer_ice_roundtrip(self):
        server = SignalingServer().start()
        events = {"ready": 0, "answers": [], "ices": []}
        sender = SignalingClient(
            server.url, room="r1", client_type="sender",
            on_ready=lambda: events.__setitem__("ready", events["ready"] + 1),
            on_answer=lambda sdp: events["answers"].append(sdp),
            on_ice=lambda c, m: events["ices"].append((c, m)),
        ).start()
        assert sender.wait_connected(10)

        viewer_msgs = []
        viewer = SignalingClient(
            server.url, room="r1", client_type="viewer",
            on_ice=lambda c, m: viewer_msgs.append(("ice", c, m)),
        ).start()
        assert viewer.wait_connected(10)

        deadline = time.time() + 5
        while events["ready"] == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert events["ready"] == 1  # viewer join -> ready at sender

        sender.send_offer("v=0 FAKE SDP OFFER")
        sender.send_ice("candidate:1 1 UDP 1 1.2.3.4 5000 typ host", 0)
        # viewer answers through the relay
        viewer._send({"type": "answer", "room": "r1", "sdp": "v=0 FAKE ANSWER"})
        viewer._send({"type": "ice", "room": "r1",
                      "candidate": "candidate:9", "sdpMLineIndex": 1})

        deadline = time.time() + 5
        while (not events["answers"] or not events["ices"]) and time.time() < deadline:
            time.sleep(0.05)
        assert events["answers"] == ["v=0 FAKE ANSWER"]
        assert events["ices"] == [("candidate:9", 1)]

        sender.stop()
        viewer.stop()
        server.stop()

    def test_reconnect_after_server_restart(self):
        server = SignalingServer().start()
        port = server.port
        client = SignalingClient(
            server.url, room="r", reconnect_delay_s=0.2,
        ).start()
        assert client.wait_connected(10)
        server.stop()
        time.sleep(0.3)
        # bring a new server up on the same port; client should rejoin
        server2 = SignalingServer(port=port).start()
        assert client.wait_connected(10)
        assert client.reconnect_count >= 1
        client.stop()
        server2.stop()


def test_env_report():
    from opencv_opencl_tpu.utils import env_report

    r = env_report()
    assert r["platform"] == "cpu"  # conftest forces cpu
    assert r["device_count"] == 8
    assert r["device_kind"]
    assert r["histogram_path"] == "XLA"
    assert r["opencv_oracle"]
    assert r["native_runtime"] in (True, False)


def test_send_ice_peer_dialect():
    """Peer-id dialect message shape (webrtc/vad.cpp family)."""
    from opencv_opencl_tpu.io.signaling import SignalingClient

    sent = []
    c = SignalingClient("ws://unused", room="r")
    c._send = sent.append  # bypass the socket
    c.send_ice_peer("candidate:42", 1, peer_id="peer-9")
    msg = sent[0]
    assert msg["type"] == "ice-candidate"
    assert msg["to"] == "peer-9"
    assert msg["candidate"]["sdpMid"] == "audio1"
    assert msg["candidate"]["sdpMLineIndex"] == 1
    c.send_ice_peer("candidate:1", 0)
    assert sent[1]["candidate"]["sdpMid"] == "video0"
    assert "to" not in sent[1]


def test_resample_fps():
    from opencv_opencl_tpu.io.videofile import resample_fps

    src = list(range(60))
    assert list(resample_fps(iter(src), 60, 30)) == list(range(0, 60, 2))
    up = list(resample_fps(iter(src[:30]), 30, 60))
    assert len(up) in (59, 60) and up[:4] == [0, 1, 1, 2]
    assert list(resample_fps(iter(src), 30, 30)) == src


def test_send_offer_from_on_ready_no_deadlock():
    """The sender app sends the offer from inside on_ready, which runs on
    the client's own event-loop thread — must not deadlock (code review
    finding: blocking .result() there starved the loop)."""
    from opencv_opencl_tpu.io.signaling import SignalingClient, SignalingServer

    server = SignalingServer().start()
    offers = []
    sender = SignalingClient(
        server.url, room="dl", client_type="sender",
        on_ready=lambda: sender.send_offer("v=0 OFFER-FROM-READY"),
    ).start()
    assert sender.wait_connected(10)
    got = []
    viewer = SignalingClient(
        server.url, room="dl", client_type="viewer",
    ).start()
    viewer.on_answer = lambda sdp: None
    # capture the raw offer at the viewer
    orig = viewer._dispatch
    def spy(raw):
        import json as _json
        m = _json.loads(raw)
        if m.get("type") == "offer":
            got.append(m["sdp"])
        orig(raw)
    viewer._dispatch = spy
    assert viewer.wait_connected(10)
    deadline = time.time() + 8
    while not got and time.time() < deadline:
        time.sleep(0.05)
    assert got == ["v=0 OFFER-FROM-READY"]
    assert sender.reconnect_count == 0  # no timeout-induced teardown
    sender.stop()
    viewer.stop()
    server.stop()


class TestWebrtcVariantBuilders:
    def test_sw_encoder_pipeline(self):
        s = gst.webrtc_pipeline_sw(codec="h264")
        assert "x264enc" in s and "tune=zerolatency" in s and "mtu=1200" in s
        s265 = gst.webrtc_pipeline_sw(codec="h265")
        assert "x265enc" in s265

    def test_vp8_pipeline(self):
        s = gst.webrtc_pipeline_vp8()
        assert "vp8enc deadline=1 cpu-used=8" in s
        assert "rtpvp8pay" in s and "format=I420" in s

    def test_audio_branch(self):
        s = gst.silent_audio_branch()
        assert "audiotestsrc wave=silence" in s
        assert "opusenc" in s and s.endswith("sendrecv.")


def test_viewer_pages_protocol():
    """The browser viewer assets speak the signaling protocol and carry the
    stats panel (the reference details.html feature set)."""
    import os

    import opencv_opencl_tpu.io as io_pkg

    base = os.path.join(os.path.dirname(io_pkg.__file__), "viewers")
    viewer = open(os.path.join(base, "viewer.html")).read()
    stats = open(os.path.join(base, "stats.html")).read()
    # the join/answer/ice protocol lives in the shared module now
    proto = open(os.path.join(base, "protocol.js")).read()
    assert '"join"' in proto
    for page in (viewer, stats):
        assert '<script src="protocol.js">' in page
        assert "RTCPeerConnection" in page
        assert "stun.l.google.com:19302" in page
        assert "addIceCandidate" in page
    # stats panel fields (reference webrtc/details.html:292-392)
    for field in ("Resolution", "Codec", "FPS", "Bitrate", "Packets lost",
                  "RTT", "getStats"):
        assert field in stats, field


def test_pyproject_entry_points():
    import tomllib

    with open("pyproject.toml", "rb") as f:
        meta = tomllib.load(f)
    scripts = meta["project"]["scripts"]
    # every console script resolves to an importable module:main
    import importlib

    for name, target in scripts.items():
        mod, fn = target.split(":")
        m = importlib.import_module(mod)
        assert callable(getattr(m, fn)), name


class TestDispatchRobustness:
    def test_malformed_messages_never_raise(self):
        """A broken/hostile peer's message must not tear down the
        websocket (the receive loop's except forces a reconnect)."""
        from opencv_opencl_tpu.io.signaling import SignalingClient

        c = SignalingClient("ws://x", "room")
        for raw in (
            "[1,2,3]", '"str"', "42", "null",
            '{"type": "answer", "answer": "notadict"}',
            '{"type": "ice", "sdpMLineIndex": "NaN!"}',
            '{"type": "ice-candidate", "candidate": "flat-string"}',
            '{"type": "ice-candidate", "candidate": {"candidate": "c",'
            ' "sdpMLineIndex": []}}',
            "not json at all",
        ):
            c._dispatch(raw)  # must not raise
        assert c.bad_messages == 9  # every malformed message counted

    def test_callback_bugs_are_not_blamed_on_the_peer(self):
        """An exception from a user callback must propagate (visible via
        the receive loop), not be counted as a bad peer message."""
        from opencv_opencl_tpu.io.signaling import SignalingClient

        def boom(sdp):
            raise ValueError("app bug")

        c = SignalingClient("ws://x", "room", on_answer=boom)
        import pytest as _pytest

        with _pytest.raises(ValueError, match="app bug"):
            c._dispatch('{"type": "answer", "sdp": "v=0"}')
        assert c.bad_messages == 0

    def test_valid_messages_still_dispatch(self):
        from opencv_opencl_tpu.io.signaling import SignalingClient

        got = []
        c = SignalingClient("ws://x", "room",
                            on_answer=lambda sdp: got.append(sdp),
                            on_ice=lambda cand, ml: got.append((cand, ml)))
        c._dispatch('{"type": "answer", "sdp": "v=0"}')
        c._dispatch('{"type": "ice", "candidate": "c1",'
                    ' "sdpMLineIndex": 1}')
        assert got == ["v=0", ("c1", 1)]
        assert c.bad_messages == 0
