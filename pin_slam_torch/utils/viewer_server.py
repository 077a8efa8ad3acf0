"""Tiny run-dir HTTP server: the live viewer and the run's control channel,
the port's copy of ``pin_slam_tpu/utils/viewer_server.py``.

``python -m pin_slam_torch.utils.viewer_server <run_dir> [port]`` serves the
run directory (so ``viewer.html``'s live poller works over HTTP instead of
``file://``) and accepts ``POST /control`` with a JSON body, which is merged
into ``<run_dir>/control.json``, the file the SLAM pipeline polls between
frames (``slam/pipeline.py`` ``SlamSystem._poll_control``).  It stands in for
the reference's in-process visualizer key callbacks that pause the run at a
loop closure or trigger a mesh (reference utils/visualizer.py:211-242,
344-346): the compute process stays headless; the browser and this server
are the interactive surface.

It binds 127.0.0.1 only: anyone who reaches the port can pause the run and
write into its directory, so it is not exposed to the network (the JAX
package's binds every interface, ROADMAP C 5).

Control keys the pipeline reads:
  pause: bool           hold before the next frame until resumed
  step: int             while paused, let N frames through
  mesh_now: bool        a mesh and viewer refresh at the next frame
  pause_at_loop: bool   pause right after a loop closure is applied
  mc_res_m, mesh_min_nn the in-run mesher's resolution and mask, from the next mesh
"""

from __future__ import annotations

import json
import os
import sys
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

HOST = "127.0.0.1"


def make_handler(run_dir: str):
    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=run_dir, **kw)

        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            if self.path.rstrip("/").endswith("control"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    patch = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self.send_error(400, "bad JSON")
                    return
                path = os.path.join(run_dir, "control.json")
                state = {}
                try:
                    with open(path) as f:
                        state = json.load(f)
                except (OSError, json.JSONDecodeError):
                    pass
                state.update(patch)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(state, f)
                os.replace(tmp, path)
                body = json.dumps(state).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

    return Handler


def make_server(run_dir: str, port: int = 8321) -> ThreadingHTTPServer:
    """The server bound to 127.0.0.1:``port`` (0: any free port), not yet
    serving."""
    return ThreadingHTTPServer((HOST, port), make_handler(run_dir))


def serve(run_dir: str, port: int = 8321):
    httpd = make_server(run_dir, port)
    print(f"serving {run_dir} at http://{HOST}:{httpd.server_address[1]}/viewer.html "
          f"(POST /control -> control.json)", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    serve(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 8321)
