"""Unix-domain-socket front end for GenerationServer (JSON lines; a copy of
uce_tpu/serving/socket_api.py, with the port's PNG writer).

Zero-egress-friendly transport: one local socket, one JSON object per
line. Request::

    {"prompt": "...", "seed": 7, "negative_prompt": "", "save_path": "x.png"}

Response (one line)::

    {"status": "ok", "path": "x.png"}                 # when save_path given
    {"status": "ok", "png_base64": "..."}             # otherwise
    {"status": "error", "error": "..."}

A request line ``{"cmd": "stats"}`` returns serving statistics (``ServerStats``:
batches, requests, padded slots, occupancy, the seconds in batches, and the
queue and fill waits);
``{"cmd": "shutdown"}`` stops the listener. Concurrent client
connections are each handled on their own thread; batching happens in
GenerationServer regardless of which connection a request arrived on.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import socket
import socketserver
import threading

import numpy as np

from uce_tpu_torch.serving.server import GenerationServer
from uce_tpu_torch.utils.imaging import encode_png, save_png

logger = logging.getLogger(__name__)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        srv: SocketFrontend = self.server.frontend  # type: ignore[attr-defined]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                reply = srv.handle_request(json.loads(raw))
            except Exception as exc:  # malformed JSON, bad fields, ...
                reply = {"status": "error", "error": str(exc)}
            self.wfile.write((json.dumps(reply) + "\n").encode())
            self.wfile.flush()
            if reply.get("shutdown"):
                return


class _ThreadingUnixServer(socketserver.ThreadingMixIn,
                           socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class SocketFrontend:
    """Owns the listening socket and translates lines <-> server calls."""

    def __init__(self, gen_server: GenerationServer, socket_path: str):
        self.gen_server = gen_server
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            # only reclaim a DEAD endpoint; blindly unlinking would steal
            # a live server's socket with no error on either side
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(1.0)
                probe.connect(socket_path)
            except (ConnectionRefusedError, FileNotFoundError):
                # the ONLY signals that prove no listener holds the
                # endpoint; a connect timeout can just mean a live but
                # starved server (full backlog, long GIL hold), and
                # unlinking then would silently steal its socket
                try:
                    os.unlink(socket_path)  # stale leftover
                except FileNotFoundError:
                    pass
            except OSError as exc:
                raise RuntimeError(
                    f"cannot tell whether {socket_path} is live ({exc}); "
                    "remove it manually if the old server is gone") from exc
            else:
                raise RuntimeError(
                    f"a server is already listening on {socket_path}")
            finally:
                probe.close()
        self._sock = _ThreadingUnixServer(socket_path, _Handler)
        self._sock.frontend = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._loop_entered = False

    def handle_request(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd == "stats":
            s = self.gen_server.stats
            return {"status": "ok", "batches": s.batches,
                    "requests": s.requests, "padded_slots": s.padded_slots,
                    "occupancy": s.occupancy,
                    "total_batch_seconds": s.total_batch_seconds,
                    "queue_wait_seconds": s.queue_wait_seconds,
                    "fill_wait_seconds": s.fill_wait_seconds,
                    "batch_sizes": list(self.gen_server.batch_sizes)}
        if cmd == "shutdown":
            threading.Thread(target=self._sock.shutdown,
                             daemon=True).start()
            return {"status": "ok", "shutdown": True}
        if "prompt" not in msg:
            return {"status": "error", "error": "missing 'prompt'"}
        image = self.gen_server.generate(
            str(msg["prompt"]), seed=int(msg.get("seed", 0)),
            negative_prompt=str(msg.get("negative_prompt", "")))
        save_path = msg.get("save_path")
        if save_path:
            save_png(np.asarray(image), save_path)
            return {"status": "ok", "path": save_path}
        return {"status": "ok",
                "png_base64": base64.b64encode(encode_png(image)).decode()}

    def serve_forever(self) -> None:
        logger.info("serving on %s", self.socket_path)
        self._loop_entered = True
        self._sock.serve_forever()

    def start_background(self) -> "SocketFrontend":
        self._loop_entered = True
        self._thread = threading.Thread(target=self._sock.serve_forever,
                                        daemon=True, name="uce-socket")
        self._thread.start()
        return self

    def close(self) -> None:
        # BaseServer.shutdown() waits on an event that only serve_forever
        # sets on exit; calling it when the loop never ran would block
        # forever (e.g. an exception between construction and
        # serve_forever reaching a finally-close).
        if self._loop_entered:
            self._sock.shutdown()
        self._sock.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


def request(socket_path: str, msg: dict, timeout: float = 600.0) -> dict:
    """One-shot client: connect, send one JSON line, read one reply."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(msg) + "\n").encode())
        buf = io.BytesIO()
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf.write(chunk)
            if chunk.endswith(b"\n"):
                break
    return json.loads(buf.getvalue().decode())
