"""Live preview over HTTP — the headless analog of the reference's GLFW
present path.

A copy of ``csgrenderer_tpu/app/preview.py`` (framework-free, so copied
rather than imported): its tonemap is the port's ``render/tonemap.py`` and
its PNG writer the port's ``io/image.py``, and ``publish`` takes a torch
tensor on any device as well as a numpy array.

The reference presents each frame to an on-screen window
(the reference's app.c:86-97 creates the GLFW window,
renderer.c:2199-2209 presents via vkQueuePresentKHR). A display-less GPU
host has no swapchain, so the same capability is delivered the
datacenter way: frames publish into an in-process latest-frame buffer
and a tiny stdlib HTTP server streams them as
``multipart/x-mixed-replace`` JPEG (the MJPEG protocol every browser and
``ffplay`` understands). Point a browser at ``http://host:port/`` while
the App loop runs.

Zero third-party dependencies required at import time: JPEG encoding
uses Pillow when present and falls back to the in-repo PNG writer
(browsers accept PNG parts in the multipart stream) otherwise.

Usage::

    server = PreviewServer(port=8400)
    server.start()
    app.frame_sink = server.sink          # App.run publishes every frame
    ...
    server.stop()

The server is a daemon ``ThreadingHTTPServer``: one thread per watching
client, each blocking on a Condition until a new frame publishes, so an
idle preview costs nothing and a slow client only skips frames (the
buffer holds the LATEST frame, never a queue — same drop-late semantics
as a real swapchain in mailbox mode).

Input events (round 4 — the reference's ``glfwPollEvents``/window-close
path, app.c:204/136): the page sends drag/wheel/key events to
``GET /input?type=...``; they land in a bounded host-side queue the App
drains via ``poll_events()`` each fixed-timestep tick (app/controls.py
wires them into an orbit camera). The queue drops OLDEST on overflow —
stale input is worthless, same drop-late policy as the frame buffer.
"""

from __future__ import annotations

import collections
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_INDEX_HTML = b"""<!doctype html>
<html><head><title>csgrenderer live preview</title>
<style>body{background:#111;margin:0;display:flex;align-items:center;
justify-content:center;height:100vh}img{max-width:100%;max-height:100%;
image-rendering:pixelated;cursor:grab;user-select:none;
-webkit-user-drag:none}</style></head>
<body><img id="v" src="/stream" alt="live render" draggable="false">
<script>
const send = q => fetch('/input?' + q).catch(() => {});
const v = document.getElementById('v');
let drag = null;
v.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (dx || dy) send(`type=orbit&dyaw=${-dx * 0.008}&dpitch=${dy * 0.006}`);
});
v.addEventListener('wheel', e => {
  e.preventDefault();
  send(`type=orbit&dzoom=${e.deltaY > 0 ? 0.5 : -0.5}`);
}, {passive: false});
window.addEventListener('keydown', e =>
  send('type=key&code=' + encodeURIComponent(e.key)));
window.addEventListener('beforeunload', () => send('type=close'));
</script></body></html>
"""


def _encode_frame(image_uint8: np.ndarray) -> tuple[bytes, str]:
    """uint8 [H, W, 3] -> (bytes, content-type). JPEG via Pillow when
    available, PNG (io/image.py pure-stdlib writer) otherwise."""
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image_uint8).save(buf, "JPEG", quality=90)
        return buf.getvalue(), "image/jpeg"
    except ImportError:
        import struct
        import zlib

        from ..io.image import _png_chunk

        h, w = image_uint8.shape[:2]
        raw = b"".join(
            b"\x00" + image_uint8[y].tobytes() for y in range(h)
        )
        return (
            b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b"")
        ), "image/png"


def _host(image) -> np.ndarray:
    """A frame as a host numpy array (a tensor is copied off its device)."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    return np.asarray(image)


class PreviewServer:
    """Latest-frame MJPEG publisher (see module docstring)."""

    def __init__(self, port: int = 8400, host: str = "127.0.0.1",
                 tonemap: bool = True):
        self._host = host
        self._port = port
        self._tonemap = tonemap
        self._cond = threading.Condition()
        self._frame: bytes | None = None
        self._ctype = "image/jpeg"
        self._seq = 0
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # bounded input queue; deque append/popleft are thread-safe and
        # maxlen drops OLDEST on overflow (stale input is worthless)
        self._events: collections.deque = collections.deque(maxlen=256)

    # -- publishing ------------------------------------------------------

    def publish(self, image) -> None:
        """Publish a frame: float radiance [H, W, 3] (tonemapped here) or
        ready uint8, as a numpy array or a torch tensor on any device.
        Called from the render loop thread; encoding is done here (once per
        frame) so N watchers cost no extra encodes."""
        img = _host(image)
        if img.dtype != np.uint8:
            if self._tonemap:
                import torch

                from ..render import tonemap as tm

                lin = torch.from_numpy(np.ascontiguousarray(img, np.float32))
                img = tm.to_uint8(tm.tonemap(lin, gamma=2.0)).numpy()
            else:
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        data, ctype = _encode_frame(np.ascontiguousarray(img))
        with self._cond:
            self._frame = data
            self._ctype = ctype
            self._seq += 1
            self._cond.notify_all()

    def sink(self, frame_index, image) -> None:
        """App.frame_sink adapter (drops the index)."""
        self.publish(image)

    # -- input events ------------------------------------------------------

    def push_event(self, event: dict) -> None:
        """Enqueue one input event (also callable from tests/scripts)."""
        self._events.append(event)

    def poll_events(self) -> list[dict]:
        """Drain pending input events, oldest first — the ``glfwPollEvents``
        analog, called from the App update callback (app/controls.attach)."""
        out = []
        while True:
            try:
                out.append(self._events.popleft())
            except IndexError:
                return out

    # -- serving ---------------------------------------------------------

    def start(self) -> tuple[str, int]:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            daemon_threads = True

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/input"):
                    q = parse_qs(urlparse(self.path).query)
                    ev = {k: v[0] for k, v in q.items() if v}
                    if ev.get("type") in ("key", "orbit", "close"):
                        outer.push_event(ev)
                        self.send_response(204)
                    else:
                        self.send_response(400)
                    self.end_headers()
                elif self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length",
                                     str(len(_INDEX_HTML)))
                    self.end_headers()
                    self.wfile.write(_INDEX_HTML)
                elif self.path == "/frame":
                    with outer._cond:
                        data, ctype = outer._frame, outer._ctype
                    if data is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=csgrframe",
                    )
                    self.end_headers()
                    seen = -1
                    try:
                        while outer._httpd is not None:
                            with outer._cond:
                                if outer._seq == seen:
                                    outer._cond.wait(timeout=1.0)
                                if outer._seq == seen or outer._frame is None:
                                    continue
                                data, ctype = outer._frame, outer._ctype
                                seen = outer._seq
                            self.wfile.write(
                                b"--csgrframe\r\n"
                                + f"Content-Type: {ctype}\r\n"
                                  f"Content-Length: {len(data)}\r\n\r\n"
                                  .encode()
                                + data + b"\r\n"
                            )
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # watcher left
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="csgr-preview",
            daemon=True,
        )
        self._thread.start()
        return self._host, self._port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        with self._cond:
            self._cond.notify_all()  # release waiting streamers
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}/"
