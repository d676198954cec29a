"""Minimal Flask-compatible routing layer on the stdlib HTTP server.

The reference serves through Flask + flask_cors (``flask_server.py:49-52``).
Neither is available in this environment and neither is necessary: this
module provides the small subset the NOTONO endpoints need — route
registration with multiple methods, query args, JSON bodies, multipart
file uploads, binary file responses, CORS headers, threaded serving —
on ``http.server.ThreadingHTTPServer``: one OS thread per connection reads
the request and writes the response, and one long-lived worker thread runs
every handler (``App.dispatch``). Model inference is serialized by the
server state's lock anyway, and the CUDA libraries keep per-thread state
(handles, convolution plans) that a fresh thread per request would build
anew each time; a warmup must go through ``dispatch`` too, to warm the
thread that serves.
"""

from __future__ import annotations

import email
import email.policy
import json
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Mapping, Optional, Tuple


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, body: bytes):
        parsed = urllib.parse.urlsplit(handler.path)
        self.path = parsed.path
        self.args = {k: v[0] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
        self.method = handler.command
        self.headers = handler.headers
        self._body = body
        self.files: Dict[str, bytes] = {}
        content_type = handler.headers.get("Content-Type", "")
        if content_type.startswith("multipart/form-data"):
            self._parse_multipart(content_type)

    def _parse_multipart(self, content_type: str) -> None:
        raw = (b"Content-Type: " + content_type.encode() + b"\r\n\r\n"
               + self._body)
        message = email.message_from_bytes(raw,
                                           policy=email.policy.default)
        for part in message.iter_parts():
            name = part.get_param("name",
                                  header="content-disposition")
            if name:
                self.files[name] = part.get_payload(decode=True)

    def get_json(self, force: bool = True):
        if not self._body:
            return {}
        return json.loads(self._body)

    @classmethod
    def synthetic(cls, path: str, query: str = "", body: bytes = b"",
                  method: str = "POST", headers=None) -> "Request":
        """Build a request without a socket, to drive the real handlers
        in-process."""
        req = cls.__new__(cls)
        req.path = path
        req.args = {k: v[0] for k, v in
                    urllib.parse.parse_qs(query).items()}
        req.method = method
        req.headers = headers or {}
        req._body = body
        req.files = {}
        return req


class Response:
    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[Mapping[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


def jsonify(payload) -> Response:
    return Response(json.dumps(payload).encode(), 200, "application/json")


def send_bytes(data: bytes, mimetype: str,
               download_name: Optional[str] = None) -> Response:
    headers = {}
    if download_name:
        headers["Content-Disposition"] = (
            f'attachment; filename="{download_name}"')
    return Response(data, 200, mimetype, headers)


class App:
    def __init__(self, name: str = "app"):
        self.name = name
        self.routes: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}
        self.logger = None
        self._worker: Optional[ThreadPoolExecutor] = None
        self._worker_lock = threading.Lock()

    def route(self, path: str, methods=("GET",)):
        def decorator(fn):
            self.routes[path] = (fn, tuple(m.upper() for m in methods))
            return fn

        return decorator

    def handle(self, request: Request) -> Response:
        entry = self.routes.get(request.path)
        if entry is None:
            return Response(json.dumps({"error": "not found",
                                        "path": request.path}).encode(),
                            404)
        fn, methods = entry
        if request.method not in methods and request.method != "OPTIONS":
            return Response(json.dumps({"error": "method not allowed"}
                                       ).encode(), 405)
        try:
            result = fn(request)
        except Exception as e:  # noqa: BLE001 — surface errors as 500 JSON
            import traceback
            traceback.print_exc()
            return Response(json.dumps({"error": repr(e)}).encode(), 500)
        if isinstance(result, Response):
            return result
        return jsonify(result)

    def dispatch(self, request: Request) -> Response:
        """``handle`` on the app's one handler thread (started at first
        use, kept for the life of the process)."""
        with self._worker_lock:
            if self._worker is None:
                self._worker = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"{self.name}-handler")
        return self._worker.submit(self.handle, request).result()

    def make_server(self, host: str, port: int) -> ThreadingHTTPServer:
        app = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                if self.command == "OPTIONS":
                    response = Response(b"", 204, "text/plain")
                else:
                    response = app.dispatch(Request(self, body))
                self.send_response(response.status)
                self.send_header("Content-Type", response.content_type)
                self.send_header("Content-Length",
                                 str(len(response.body)))
                # CORS (flask_cors parity)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods",
                                 "GET, POST, OPTIONS")
                self.send_header("Access-Control-Allow-Headers",
                                 "Content-Type")
                for k, v in response.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if response.body:
                    self.wfile.write(response.body)

            do_GET = do_POST = do_OPTIONS = _respond

            def log_message(self, fmt, *args):  # route to app logger
                if app.logger is not None:
                    app.logger.info("%s - %s", self.address_string(),
                                    fmt % args)

        return ThreadingHTTPServer((host, port), Handler)

    def run(self, host: str = "0.0.0.0", port: int = 5000,
            threaded: bool = True, background: bool = False):
        server = self.make_server(host, port)
        if background:
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            return server
        server.serve_forever()
