"""HTTP serving front end over the continuous-batching engine.

Port of ``onebit_tpu/engine/server.py``:

* ``POST /generate``: body ``{"prompt": [ids...] | "text": str,
  "max_new_tokens": int, "stream": bool}``. Without ``stream`` the answer
  is one JSON object ``{"tokens": [...]}``; with ``stream: true``
  newline-delimited JSON chunks, ``{"token": id}`` as each token lands,
  then ``{"done": true, "tokens": [...]}``. A server given a ``tokenizer``
  (a callable whose result holds ``"input_ids"``, with a ``decode``, as a
  Hugging Face tokenizer is) takes ``text``, encoded as
  ``tokenizer(text)["input_ids"]``, and adds ``"text"``, the decoded
  tokens, to both final replies; one built without a tokenizer answers a
  ``text`` body 400, naming it.
* ``GET /metrics``: the engine's counters as JSON
  (``ContinuousBatchingEngine.metrics``): requests, tokens, queue depth,
  active slots, TTFT and TPOT quantiles, ``prefill_rows_run`` and
  ``prefill_rows_needed`` (prefill rows the model ran, padding included,
  and those the prompts needed), ``blocks_dispatched``,
  ``pipeline_flushes`` (pipelines an admission flushed) and, paged,
  ``free_pages``, ``total_pages``, ``pages_reserved`` and
  ``pages_written``. ``tokens_per_second_ema`` is gone: rates come from
  two readings of ``total_tokens``.
* ``GET /health``: liveness.

Threading: the handlers of a stdlib ``ThreadingHTTPServer`` add requests
to the engine under a lock, and one background thread owns every device
call (``engine.step()``; the engine makes its own device and stream
current for each step). Handlers stream tokens from a queue a request
that the engine's ``on_token`` hook fills. If a step raises, the engine
thread stops, and every request waiting or arriving answers 500 with the
error.
"""

from __future__ import annotations

import json
import queue
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

NO_TOKENIZER = ("'text' needs a tokenizer, and this server was started "
                "without one (serve --tokenizer DIR): send 'prompt' as "
                "token ids")


class EngineServer:
    """Drives a ContinuousBatchingEngine from an HTTP front end."""

    def __init__(self, engine, tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.error: Optional[str] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- engine thread ------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                has_work = self.engine.has_work()
                if has_work:
                    try:
                        self.engine.step()
                    except Exception as e:   # noqa: BLE001
                        # the engine's state is unknown after a failed
                        # step: stop serving, and say why to every
                        # request
                        traceback.print_exc()
                        self.error = f"{type(e).__name__}: {e}"
                        self._stop.set()
                        return
            if not has_work:
                # idle: sleep until a request arrives
                self._wake.wait(timeout=0.1)
                self._wake.clear()

    def submit(self, prompt, max_new_tokens: int,
               on_token: Callable, on_done: Callable) -> int:
        with self._lock:
            uid = self.engine.add_request(prompt,
                                          max_new_tokens=max_new_tokens,
                                          on_token=on_token,
                                          on_done=on_done)
        self._wake.set()
        return uid

    def final(self, toks, done: bool = True) -> dict:
        """A request's last reply: its tokens, and their text where the
        server has a tokenizer."""
        out = {"done": True} if done else {}
        out["tokens"] = toks
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(toks)
        return out

    def metrics(self) -> dict:
        with self._lock:
            return self.engine.metrics()

    # -- lifecycle ----------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine thread and the HTTP server; returns the bound
        port."""
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._json(200, server.metrics())
                elif self.path == "/health":
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": "unknown path"})

            def _next(self, q):
                """The request's next (kind, token), or None once the
                engine thread has failed."""
                while True:
                    try:
                        return q.get(timeout=0.5)
                    except queue.Empty:
                        if server.error is not None:
                            return None

            def do_POST(self):
                if self.path != "/generate":
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if "prompt" in body:
                        prompt = [int(t) for t in body["prompt"]]
                    elif "text" in body and server.tokenizer is not None:
                        prompt = server.tokenizer(body["text"])["input_ids"]
                    elif "text" in body:
                        raise ValueError(NO_TOKENIZER)
                    else:
                        raise ValueError("need 'prompt' (token ids) or "
                                         "'text'")
                    max_new = int(body.get("max_new_tokens", 64))
                    stream = bool(body.get("stream", False))
                    if server.error is not None:
                        self._json(500, {"error": server.error})
                        return
                    q: "queue.Queue" = queue.Queue()
                    server.submit(prompt, max_new,
                                  on_token=lambda t: q.put(("tok", t)),
                                  on_done=lambda: q.put(("done", None)))
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return

                toks = []
                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(obj):
                        data = (json.dumps(obj) + "\n").encode()
                        self.wfile.write(hex(len(data))[2:].encode()
                                         + b"\r\n" + data + b"\r\n")

                    while True:
                        got = self._next(q)
                        if got is None or got[0] == "done":
                            chunk(server.final(toks)
                                  if got else {"error": server.error})
                            self.wfile.write(b"0\r\n\r\n")
                            return
                        toks.append(got[1])
                        chunk({"token": got[1]})
                while True:
                    got = self._next(q)
                    if got is None:
                        self._json(500, {"error": server.error})
                        return
                    if got[0] == "done":
                        break
                    toks.append(got[1])
                self._json(200, server.final(toks, done=False))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
