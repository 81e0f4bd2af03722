"""HTTP serving front end: an OpenAI-style completions API over the
engine or router.

Counterpart of ``micromix_tpu/serve/api.py``, with its endpoints, request
fields, SSE framing, stop-string handling and ``/metrics`` lines.
Standard library only (``ThreadingHTTPServer``).

Design: HTTP handler threads never touch the engine.  One scheduler
thread owns every Engine / Router call behind a single lock: handlers
submit requests and cancels through queues and wait on per-request
events; streaming responses read a per-request token queue fed by the
engine's ``on_token`` callback (which fires inside the scheduler thread's
``step()``).  So the card's launches come from one thread on one stream,
and concurrency lives at the HTTP edge.  The scheduler applies the
admissions and cancels queued since its last step at the next step
boundary, and steps only while the engines have work.  Over ranks
(``parallel.replicas.ReplicaRouter``: one replica of TP or EP ranks, or
several), the router carries the boundary to the other ranks itself; the
scheduler calls its ``heartbeat`` every ``HEARTBEAT_S`` seconds while
idle (well inside gloo's 30-minute timeout of a follower's wait).  A
router call that raises (a rank died) ends the scheduler: every waiting
request is released, a new completion gets 503, and ``close`` raises
the error.

Endpoints:
  POST /v1/completions   prompt, max_tokens, temperature, top_k, top_p,
                         min_p, repetition_penalty, min_new_tokens,
                         logprobs, stop (strings) / stop_token_ids,
                         stream (SSE)
  POST /v1/chat/completions   messages [{role, content}], same sampling
                         params; rendered through ``chat_template``
  GET  /v1/models        model listing
  GET  /health           liveness
  GET  /metrics          text-format counters (Prometheus-style)
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from .engine import Request
from .router import Router
from .sampling import SamplingParams

HEARTBEAT_S = 10.0


class _Live:
    """Book-keeping for one in-flight request."""

    __slots__ = ("req", "done", "tokens", "created", "stop_strs")

    def __init__(self, req: Request, streaming: bool):
        self.req = req
        self.done = threading.Event()
        self.tokens: Optional[queue.Queue] = (
            queue.Queue() if streaming else None)
        self.created = time.time()
        self.stop_strs: List[str] = []


class ApiServer:
    """OpenAI-style completions server over an Engine or Router.

    ``encode``/``decode`` adapt any tokenizer (HF fast tokenizers via
    ``tok.encode``/``tok.decode``).  ``port=0`` binds an ephemeral port
    (tests); ``serve_forever`` blocks, or use start()/close() for
    embedding.
    """

    def __init__(self, engine, encode: Callable[[str], List[int]],
                 decode: Callable[[List[int]], str], *,
                 model_name: str = "micromix", eos_id: Optional[int] = None,
                 max_new_tokens_cap: int = 2048,
                 chat_template: Optional[
                     Callable[[List[Dict[str, str]]], str]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.router = engine if isinstance(engine, Router) \
            else Router([engine])
        self.error: Optional[BaseException] = None
        self.encode = encode
        self.decode = decode
        self.model_name = model_name
        self.eos_id = eos_id
        self.cap = max_new_tokens_cap
        self.chat_template = chat_template or _default_chat_template
        self._lock = threading.Lock()        # guards ALL engine access
        self._submit_q: "queue.Queue[_Live]" = queue.Queue()
        self._cancel_q: "queue.Queue[int]" = queue.Queue()
        self._live: Dict[int, _Live] = {}
        self._next_id = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.requests_total = 0
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._threads: List[threading.Thread] = []

    # ---------------- scheduler thread ----------------

    @staticmethod
    def _drain(q: queue.Queue) -> list:
        out = []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    @staticmethod
    def _release(lvs: List[_Live]) -> None:
        """End the waiters of requests the scheduler will not serve."""
        for lv in lvs:
            if lv.tokens is not None:
                lv.tokens.put(None)
            lv.done.set()

    def _scheduler(self) -> None:
        try:
            self._schedule()
        except BaseException as e:      # noqa: BLE001 (raised by close)
            self.error = e
            with self._lock:
                live, self._live = list(self._live.values()), {}
            self._release(live + self._drain(self._submit_q))

    def _schedule(self) -> None:
        working, last = False, time.monotonic()
        while not self._stop.is_set():
            admits = self._drain(self._submit_q)
            cancels = self._drain(self._cancel_q)
            busy = bool(admits or cancels) or working
            with self._lock:
                for lv in admits:
                    self._live[lv.req.req_id] = lv
                    self.router.submit(lv.req)
                for rid in cancels:
                    self.router.cancel(rid)
                # an engine whose step found no work stays idle until the
                # next admission or cancel
                working = busy and self.router.step()
                if busy:
                    last = time.monotonic()
                elif time.monotonic() - last >= HEARTBEAT_S:
                    self.router.heartbeat()
                    last = time.monotonic()
                finished = [rid for rid, lv in self._live.items()
                            if lv.req.done]
                for rid in finished:
                    lv = self._live.pop(rid)
                    if lv.tokens is not None:
                        lv.tokens.put(None)  # stream sentinel
                    lv.done.set()
            if not working:
                # idle: wait for the next submission instead of spinning
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    # ---------------- request plumbing ----------------

    def _build_request(self, body: Dict[str, Any], streaming: bool
                       ) -> _Live:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):  # pre-tokenized (OpenAI allows ids)
            ids = [int(x) for x in prompt]
        else:
            ids = list(self.encode(str(prompt)))
        sampling = SamplingParams(
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            min_p=float(body.get("min_p", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            min_new_tokens=int(body.get("min_new_tokens", 0)))
        stop_ids = [int(x) for x in body.get("stop_token_ids", [])]
        # single-token `stop` strings become stop_ids (exact in-engine
        # stop); multi-token strings are matched host-side on the decoded
        # text (see _stop_strings handling in the waiters)
        stop_strs: List[str] = []
        stop = body.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        for s in stop or []:
            enc = list(self.encode(s))
            if len(enc) == 1:
                stop_ids.append(enc[0])
            else:
                stop_strs.append(s)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self.requests_total += 1
        req = Request(
            req_id=rid, prompt=ids,
            max_new_tokens=max(1, min(int(body.get("max_tokens", 16)),
                                      self.cap)),
            sampling=sampling, eos_id=self.eos_id,
            stop_ids=stop_ids or None,
            logprobs=bool(body.get("logprobs", False)))
        lv = _Live(req, streaming)
        lv.stop_strs = stop_strs
        if streaming:
            tq = lv.tokens
            req.on_token = lambda t, q=tq: q.put(int(t))
        return lv

    def submit(self, lv: _Live) -> None:
        self._submit_q.put(lv)
        self._wake.set()
        if self.error is not None:
            # the scheduler is gone: nothing would release the waiters
            # (this one, and any other handler's queued meanwhile)
            self._release(self._drain(self._submit_q) + [lv])

    def cancel(self, req_id: int) -> bool:
        """Queue a cancel for the next step boundary and release the
        request's waiter now; False if the request is not live."""
        self._cancel_q.put(req_id)
        self._wake.set()
        with self._lock:
            lv = self._live.pop(req_id, None)
        if lv is not None:
            if lv.tokens is not None:
                lv.tokens.put(None)
            lv.done.set()
        return lv is not None

    def _finish_reason(self, req: Request) -> str:
        return "length" if len(req.output) >= req.max_new_tokens \
            else "stop"

    @staticmethod
    def _strip_stop(req: Request, ids: List[int]) -> List[int]:
        """Drop a trailing eos/stop token from the RETURNED ids (the
        engine records it in req.output; OpenAI-style responses exclude
        it from the text)."""
        if ids and ((req.eos_id is not None and ids[-1] == req.eos_id)
                    or (req.stop_ids and ids[-1] in req.stop_ids)):
            return ids[:-1]
        return ids

    def _completion_json(self, req: Request, text: str, finish: str,
                         chat: bool = False) -> Dict[str, Any]:
        if chat:
            choice: Dict[str, Any] = {
                "index": 0, "finish_reason": finish,
                "message": {"role": "assistant", "content": text}}
        else:
            choice = {"index": 0, "text": text, "finish_reason": finish}
        out: Dict[str, Any] = {
            "id": f"{'chatcmpl' if chat else 'cmpl'}-"
                  f"{uuid.uuid4().hex[:24]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(req.prompt),
                "completion_tokens": len(req.output),
                "total_tokens": len(req.prompt) + len(req.output),
            },
        }
        if req.logprobs:
            out["choices"][0]["logprobs"] = {
                "token_logprobs": [round(p, 6)
                                   for p in req.token_logprobs]}
        return out

    def _metrics_text(self) -> str:
        with self._lock:
            st = self.router.stats
            engines = self.router.engines
            lines = [
                f"micromix_requests_total {self.requests_total}",
                f"micromix_requests_live {len(self._live)}",
                f"micromix_decode_tokens_total "
                f"{sum(st['decode_tokens'])}",
                f"micromix_prefill_tokens_total "
                f"{sum(st['prefill_tokens'])}",
                f"micromix_preemptions_total {sum(st['preemptions'])}",
            ]
            ttfts = [t for e in engines for t in e.ttft.values()]
            if ttfts:
                lines.append(
                    f"micromix_ttft_seconds_sum {sum(ttfts):.6f}")
                lines.append(f"micromix_ttft_seconds_count {len(ttfts)}")
            prop = sum(e.spec_proposed for e in engines)
            if prop:
                acc = sum(e.spec_accepted for e in engines)
                lines.append(
                    f"micromix_spec_accept_rate {acc / prop:.6f}")
        return "\n".join(lines) + "\n"

    # ---------------- HTTP layer ----------------

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _json(self, code: int, obj: Dict[str, Any]) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [{
                        "id": server.model_name, "object": "model",
                        "owned_by": "micromix_tpu"}]})
                elif self.path == "/metrics":
                    body = server._metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                chat = self.path == "/v1/chat/completions"
                if self.path != "/v1/completions" and not chat:
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if chat:
                        body = dict(body)
                        body["prompt"] = server.chat_template(
                            body.get("messages", []))
                except (ValueError, TypeError, KeyError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    if body.get("stream"):
                        self._stream(body, chat=chat)
                    else:
                        self._complete(body, chat=chat)
                except BrokenPipeError:
                    pass  # client went away mid-response

            def _complete(self, body, chat=False):
                lv = server._build_request(body, streaming=False)
                server.submit(lv)
                lv.done.wait()
                if server.error is not None:
                    self._json(503, {"error": f"server failed: {server.error}"})
                    return
                req = lv.req
                text = server.decode(server._strip_stop(req, req.output))
                text, trimmed = _trim_stops(text, lv.stop_strs)
                finish = "stop" if trimmed else server._finish_reason(req)
                self._json(200, server._completion_json(req, text, finish,
                                                        chat=chat))

            def _stream(self, body, chat=False):
                lv = server._build_request(body, streaming=True)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                server.submit(lv)
                req, sent = lv.req, 0
                finish = None

                def ev(delta_text, fin):
                    if chat:
                        d: Dict[str, Any] = {}
                        if fin is None:
                            d["content"] = delta_text
                        choice = {"index": 0, "delta": d,
                                  "finish_reason": fin}
                    else:
                        choice = {"index": 0, "text": delta_text,
                                  "finish_reason": fin}
                    return json.dumps({
                        "id": f"{'chatcmpl' if chat else 'cmpl'}-"
                              f"{req.req_id}",
                        "object": ("chat.completion.chunk" if chat
                                   else "text_completion"),
                        "model": server.model_name,
                        "choices": [choice]})

                try:
                    if chat:  # role announcement chunk (OpenAI shape)
                        self._chunk(json.dumps({
                            "id": f"chatcmpl-{req.req_id}",
                            "object": "chat.completion.chunk",
                            "model": server.model_name,
                            "choices": [{"index": 0,
                                         "delta": {"role": "assistant"},
                                         "finish_reason": None}]}))
                    while True:
                        tok = lv.tokens.get()
                        if tok is None:
                            break
                        sent += 1
                        if (req.eos_id is not None and tok == req.eos_id) \
                                or (req.stop_ids
                                    and tok in req.stop_ids):
                            finish = "stop"  # excluded from the text
                            continue
                        text = server.decode(req.output[:sent])
                        prev = server.decode(req.output[:sent - 1]) \
                            if sent > 1 else ""
                        delta = text[len(prev):]
                        trimmed_text, trimmed = _trim_stops(
                            text, lv.stop_strs)
                        if trimmed:
                            delta = trimmed_text[len(prev):]
                            finish = "stop"
                        self._chunk(ev(delta, None))
                        if trimmed:
                            server.cancel(req.req_id)
                            break
                    self._chunk(ev("", finish or
                                   server._finish_reason(req)))
                    self._chunk("[DONE]")
                    self.wfile.write(b"0\r\n\r\n")  # end chunked body
                except (BrokenPipeError, ConnectionResetError):
                    # client disconnect mid-stream aborts the request so
                    # its slot/pages free at the next step boundary
                    server.cancel(req.req_id)

            def _chunk(self, data: str) -> None:
                payload = f"data: {data}\n\n".encode()
                self.wfile.write(
                    f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
                self.wfile.flush()

        return Handler

    # ---------------- lifecycle ----------------

    def start(self) -> None:
        t1 = threading.Thread(target=self._scheduler, daemon=True,
                              name="micromix-scheduler")
        t2 = threading.Thread(target=self._httpd.serve_forever,
                              daemon=True, name="micromix-http")
        t1.start()
        t2.start()
        self._threads = [t1, t2]

    def serve_forever(self) -> None:
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self) -> None:
        """Stop serving; the scheduler ends after its current step (a
        router over ranks may then be closed).  Raises the error that
        ended the scheduler, if one did."""
        self._stop.set()
        self._wake.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._threads:
            t.join(None if t.name == "micromix-scheduler" else 5)
        if self.error is not None:
            raise RuntimeError("the server's scheduler failed") from self.error


def _default_chat_template(messages: List[Dict[str, str]]) -> str:
    """Plain-text fallback template (HF tokenizers with a real chat
    template are passed in via ``chat_template=tok.apply_chat_template``
    — the CLI does so when the tokenizer has one)."""
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    return "\n".join(lines + ["assistant:"])


def _trim_stops(text: str, stop_strs: List[str]):
    """Host-side multi-token stop-string matching: truncate at the
    earliest stop occurrence.  Returns (text, trimmed?)."""
    cut = None
    for s in stop_strs or []:
        i = text.find(s)
        if i >= 0 and (cut is None or i < cut):
            cut = i
    return (text if cut is None else text[:cut]), cut is not None


__all__ = ["ApiServer"]
