"""Live progressive preview over HTTP (counterpart of the JAX package's
``preview.py``).

A small in-process server for headless GPU hosts: point a browser at
http://host:port/ and the page reloads the current image every two seconds
while the render runs.  Only the standard library's ``http.server`` and the
port's PNG encoder; the render loop pushes frames with
``PreviewServer.update(image)``, a host-side encode of an image the loop has
already copied to the host.
"""

from __future__ import annotations

import http.server
import threading

from . import io as sptio

_PAGE = b"""<!doctype html>
<html><head><title>simplepathtracer_tpu_torch live preview</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;height:100vh}
img{max-width:96vw;max-height:90vh;image-rendering:pixelated}
p{color:#888;font:12px monospace}</style></head>
<body><div><img id=i src="/frame.png">
<p id=s>waiting for first frame...</p></div>
<script>
let prev = null;
async function tick(){
  try {
    const r = await fetch('/frame.png?' + Date.now());
    if (r.ok) {
      const b = await r.blob();
      const url = URL.createObjectURL(b);
      document.getElementById('i').src = url;
      if (prev) URL.revokeObjectURL(prev);  // one blob live at a time
      prev = url;
      const st = await (await fetch('/status')).text();
      document.getElementById('s').textContent = st;
    }
  } catch (e) {
    // transient fetch failure (server restart, network blip): keep polling
  }
  setTimeout(tick, 2000);
}
tick();
</script></body></html>"""


class PreviewServer:
    """Serves the latest pushed frame at / (page), /frame.png, /status."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._png: bytes | None = None
        self._status = "no frames yet"
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body, ctype = _PAGE, "text/html"
                elif path == "/frame.png":
                    with outer._lock:
                        body = outer._png
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    ctype = "image/png"
                elif path == "/status":
                    with outer._lock:
                        body = outer._status.encode()
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="spt-preview", daemon=True
        )
        self._thread.start()

    def update(self, image, status: str = "") -> None:
        """Push a new frame: [H, W, 3] float image in [0, 1] (an array or a
        tensor)."""
        png = sptio.encode_png(image)
        with self._lock:
            self._png = png
            if status:
                self._status = status

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
