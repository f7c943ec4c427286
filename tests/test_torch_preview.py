"""The port's live MJPEG preview server (app/preview.py, a copy of the JAX
package's) on the CPU: tests/test_preview.py's tests on the port, every
server on port 0 (a free port, as the suite runs in several workers), and
the port's own addition, frames published as torch tensors."""

import threading
import urllib.error
import urllib.request

import numpy as np
import torch

from csgrenderer_tpu.app.preview import _encode_frame as j_encode_frame
from csgrenderer_tpu_torch.app.preview import PreviewServer, _encode_frame


def test_encode_frame_roundtrip():
    img = (np.arange(8 * 6 * 3, dtype=np.uint8).reshape(6, 8, 3) * 3) % 255
    data, ctype = _encode_frame(img)
    assert len(data) > 0
    if ctype == "image/jpeg":
        assert data[:2] == b"\xff\xd8"  # JPEG SOI
    else:
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert (data, ctype) == j_encode_frame(img)  # the same encoder, byte for byte


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read(), r.headers["Content-Type"]


def test_frame_endpoint_and_float_sink():
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()
        assert port != 0 and srv.url == f"http://{host}:{port}/"
        # 503 before the first publish
        try:
            urllib.request.urlopen(f"http://{host}:{port}/frame", timeout=5)
            assert False, "expected 503"
        except urllib.error.HTTPError as e:
            assert e.code == 503
        # float radiance goes through the tonemap (the App sink contract)
        srv.sink(0, np.full((6, 8, 3), 0.25, np.float32))
        body, ctype = _get(f"http://{host}:{port}/frame")
        assert ctype in ("image/jpeg", "image/png") and len(body) > 0
        page, _ = _get(f"http://{host}:{port}/")
        assert b"/stream" in page
    finally:
        srv.stop()


def test_publish_takes_torch_tensors():
    """A float tensor is tonemapped (gamma 2: 0.25 -> 0.5 -> 128) and a
    uint8 tensor published as it is; both encode as the numpy frame does."""
    srv = PreviewServer(port=0)
    expect = np.full((6, 8, 3), 128, np.uint8)
    srv.publish(torch.full((6, 8, 3), 0.25))
    assert srv._frame == _encode_frame(expect)[0]
    srv.sink(3, torch.from_numpy(expect))
    assert srv._frame == _encode_frame(expect)[0] and srv._seq == 2
    srv.publish(np.full((6, 8, 3), 0.25, np.float32))
    assert srv._frame == _encode_frame(expect)[0]


def test_stream_delivers_published_frames():
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()
        srv.publish(np.zeros((4, 4, 3), np.uint8))
        got = {}

        def watch():
            req = urllib.request.urlopen(f"http://{host}:{port}/stream", timeout=10)
            assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
            # read through the first part (boundary, headers, payload)
            assert req.readline().strip() == b"--csgrframe"
            headers = {}
            while True:
                ln = req.readline().strip()
                if not ln:
                    break
                k, v = ln.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
            got["frame"] = req.read(int(headers[b"content-length"]))
            req.close()

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert len(got["frame"]) > 0
    finally:
        srv.stop()


def test_input_endpoint_enqueues_events():
    """Browser input (the reference's event poll, app.c:204): /input events
    land in the queue in order; bad types are refused; poll_events drains."""
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()

        def get(q):
            try:
                with urllib.request.urlopen(f"http://{host}:{port}/input?{q}", timeout=5) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        assert get("type=key&code=Escape") == 204
        assert get("type=orbit&dyaw=0.1&dpitch=-0.05&dzoom=0.5") == 204
        assert get("type=close") == 204
        assert get("type=evil") == 400
        assert get("nonsense=1") == 400
        evs = srv.poll_events()
        assert [e["type"] for e in evs] == ["key", "orbit", "close"]
        assert evs[0]["code"] == "Escape"
        assert float(evs[1]["dyaw"]) == 0.1
        assert srv.poll_events() == []  # drained
    finally:
        srv.stop()


def test_index_page_sends_input():
    srv = PreviewServer(port=0)
    try:
        host, port = srv.start()
        page, _ = _get(f"http://{host}:{port}/")
        assert b"/input?" in page and b"mousedown" in page
    finally:
        srv.stop()
