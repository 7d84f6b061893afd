"""Viewer-page protocol coverage (reference ``webrtc/*.html`` + the
vad.cpp peer-id dialect) — node-less: the in-repo server serves the
pages and a PYTHON viewer replays the peer-id message sequence over
real websockets; the JS module itself is exercised by
``viewers/protocol_test.html`` in any browser (served at
``/protocol_test.html``) and structurally checked here."""

from __future__ import annotations

import json
import time
import urllib.request
from pathlib import Path

from opencv_opencl_tpu.io.signaling import SignalingClient, SignalingServer

VIEWERS = Path(__file__).resolve().parent.parent / (
    "opencv_opencl_tpu/io/viewers")


class TestPageServing:
    def test_server_serves_viewer_pages_over_http(self):
        server = SignalingServer().start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            for path, marker in [
                ("/", "Relay viewer"),
                ("/viewer.html", "protocol.js"),
                ("/stats.html", "Connection stats"),
                ("/protocol.js", "createViewerProtocol"),
                ("/protocol_test.html", "protocol.js dialect tests"),
            ]:
                with urllib.request.urlopen(base + path, timeout=5) as r:
                    body = r.read().decode()
                    assert r.status == 200
                    assert marker in body, path
            # content types
            with urllib.request.urlopen(base + "/protocol.js",
                                        timeout=5) as r:
                assert "javascript" in r.headers["Content-Type"]
            # 404 for anything else
            try:
                urllib.request.urlopen(base + "/etc/passwd", timeout=5)
                raise AssertionError("expected 404")
            except urllib.error.HTTPError as e:
                assert e.code == 404
        finally:
            server.stop()

    def test_websocket_still_works_alongside_http(self):
        server = SignalingServer().start()
        try:
            c = SignalingClient(server.url, room="ws-ok",
                                client_type="sender").start()
            assert c.wait_connected(10)
            c.stop()
        finally:
            server.stop()


class TestPeerIdViewerRoundTrip:
    def test_python_viewer_speaks_peer_id_dialect(self):
        """The vad.cpp message sequence end-to-end through the in-repo
        server: registered -> offer(from) -> answer(to) -> nested
        ice-candidate both ways."""
        server = SignalingServer().start()
        sender_got = {"answer": None, "ice": None, "ready_from": None}
        viewer_got = {"offer_from": None, "my_id": None}

        try:
            sender = SignalingClient(
                server.url, room="pid", client_type="sender",
                on_answer=lambda sdp: sender_got.__setitem__("answer", sdp),
                on_ice=lambda c, m: sender_got.__setitem__("ice", (c, m)),
            ).start()
            assert sender.wait_connected(10)

            def on_offer(sdp, frm):
                viewer_got["offer_from"] = frm
                # the vad-family browser answers with a to-addressed
                # message (answer-carries-from protocol)
                viewer.send_answer("v=0\r\nanswer-sdp\r\n", to=frm)
                viewer.send_ice_peer("candidate:v 1 UDP 1", 1, peer_id=frm)

            viewer = SignalingClient(
                server.url, room="pid", client_type="viewer",
                on_offer=on_offer,
                on_registered=lambda i: viewer_got.__setitem__("my_id", i),
            ).start()
            assert viewer.wait_connected(10)

            deadline = time.monotonic() + 10
            while viewer_got["my_id"] is None and time.monotonic() < deadline:
                time.sleep(0.02)
            assert viewer_got["my_id"]  # registered (peer-id dialect)

            sender.send_offer("v=0\r\noffer-sdp\r\n")
            deadline = time.monotonic() + 10
            while (sender_got["answer"] is None
                   or sender_got["ice"] is None) and (
                       time.monotonic() < deadline):
                time.sleep(0.02)
            # the offer reached the viewer stamped with the sender's id
            assert viewer_got["offer_from"]
            # to-addressed answer and nested ICE routed back to the sender
            assert sender_got["answer"] == "v=0\r\nanswer-sdp\r\n"
            assert sender_got["ice"] == ("candidate:v 1 UDP 1", 1)
            assert sender.remote_peer_id == viewer_got["my_id"]
            sender.stop()
            viewer.stop()
        finally:
            server.stop()


class TestProtocolJsStructure:
    """Structural conformance of the JS module (no JS engine in this
    container; protocol_test.html executes it in any real browser)."""

    def test_pages_load_shared_module(self):
        for page in ("viewer.html", "stats.html", "protocol_test.html"):
            text = (VIEWERS / page).read_text()
            assert '<script src="protocol.js">' in text, page

    def test_module_covers_both_dialects(self):
        js = (VIEWERS / "protocol.js").read_text()
        # peer-id dialect elements (vad.cpp family)
        for token in ('"registered"', '"ice-candidate"',
                      "end-of-candidates", '"audio1"', '"video0"',
                      "state.peerId", "ans.to"):
            assert token in js, token
        # room dialect elements (sender.cpp / inn.html)
        for token in ('"ice"', "ans.room", "sdpMLineIndex"):
            assert token in js, token

    def test_pages_route_ice_through_module(self):
        for page in ("viewer.html", "stats.html"):
            text = (VIEWERS / page).read_text()
            assert "proto.sendLocalIce" in text, page
            assert "proto.handleMessage" in text, page
            assert "proto.joinMessage" in text, page

    def test_harness_reports_machine_readable_summary(self):
        text = (VIEWERS / "protocol_test.html").read_text()
        assert "id=\"summary\"" in text
        assert "'PASS '" in text and "'FAIL '" in text
