"""Gemini-compatible HTTP API server (counterpart of gemma_tpu/api_server.py;
reference gemma/api_server.cc).

Endpoints (api_server.cc:450-471):
  GET  /v1beta/models
  POST /v1beta/models/<model>:generateContent
  POST /v1beta/models/<model>:streamGenerateContent     (SSE)

Sessions: `sessionId` in the request body keys a {KVCache, abs_pos} pair,
expired after 30 minutes of inactivity (api_server.cc:75-97); a single
inference mutex serializes generation, or, with --continuous, the
continuous batcher (engine/serving.py) serves every request, sessions
included, from one thread that owns the card.  stdlib http.server replaces
cpp-httplib; the engine is the same one the REPL uses, on CUDA unless
--device names another device.

    python -m gemma_tpu_torch.api_server --weights model.sbs --port 8000
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gemma_tpu_torch.args import (
    InferenceArgs,
    LoaderArgs,
    add_args,
    extract,
    load_gemma,
)
from gemma_tpu_torch.models.tokenizer import wrap_and_tokenize

SESSION_EXPIRY_S = 30 * 60


class Session:
    def __init__(self, cache):
        self.cache = cache
        self.abs_pos = 0
        self.last_access = time.monotonic()
        # Serializes turns of ONE conversation (its KV rows are adopted by
        # a batcher slot for the turn's duration); different sessions and
        # sessionless requests still share decode waves.
        self.lock = threading.Lock()


class GemmaService:
    """Model + session state shared by all requests (ServerState analog).

    continuous=True replaces the single inference mutex with the
    continuous-batching scheduler (engine/serving.py): concurrent requests
    share decode steps instead of queueing behind each other.  Requests
    with a sessionId (KV reuse, api_server.cc:89-97) join the same decode
    waves: the batcher adopts the session's KVCache into a slot for the
    turn and hands the rows back at retirement (the
    reference serializes everything behind one mutex, api_server.cc:56-97).
    Only the batcher's thread launches kernels then: handler threads
    submit requests and read the tokens it hands them.
    """

    def __init__(self, gemma, model_name: str = "gemma",
                 continuous: bool = False):
        self.gemma = gemma
        self.model_name = model_name
        self.sessions: dict[str, Session] = {}
        self.sessions_lock = threading.Lock()
        self.inference_lock = threading.Lock()
        self.batcher = None
        if continuous:
            from gemma_tpu_torch.engine.serving import ContinuousBatcher

            self.batcher = ContinuousBatcher(gemma.engine)
            self._batcher_wake = threading.Condition()
            thread = threading.Thread(target=self._batcher_loop, daemon=True)
            thread.start()

    def _batcher_loop(self) -> None:
        while True:
            with self._batcher_wake:
                while not (self.batcher.pending or self.batcher.active):
                    self._batcher_wake.wait()
            self.batcher.step()

    def _generate_continuous(self, request: dict, on_chunk=None) -> dict:
        import queue

        from gemma_tpu_torch.engine.serving import Request

        gemma = self.gemma
        prompt = self.wrap_messages(request["contents"])
        gen_cfg = request.get("generationConfig", {})
        max_tokens = int(gen_cfg.get("maxOutputTokens", 8192))

        session_id = request.get("sessionId")
        session = (self.get_or_create_session(session_id)
                   if session_id else None)
        if session is not None:
            # One turn of a conversation at a time (its rows live in a
            # batcher slot for the turn); other sessions/requests still
            # share the same decode waves.
            session.lock.acquire()
        try:
            start = session.abs_pos if session is not None else 0
            tokens = wrap_and_tokenize(
                gemma.tokenizer, gemma.chat_template, gemma.config.wrapping,
                start, prompt)

            fifo: queue.Queue = queue.Queue()

            def on_token(req, tok) -> bool:
                fifo.put(tok)
                return True

            req = Request(tokens, max_tokens=max_tokens, on_token=on_token,
                          cache=session.cache if session is not None
                          else None,
                          start_pos=start)
            with self._batcher_wake:
                self.batcher.submit(req)
                self._batcher_wake.notify()

            pieces: list[str] = []
            generated = 0
            while True:
                try:
                    tok = fifo.get(timeout=0.05)
                except queue.Empty:
                    if req.done:
                        break
                    continue
                generated += 1
                if gemma.config.is_eos(tok):
                    break
                text = gemma.tokenizer.decode([tok])
                pieces.append(text)
                if on_chunk is not None:
                    on_chunk(text)
            while not req.done:  # cache hand-back precedes done
                time.sleep(0.005)
            if session is not None:
                # Mirrors the serialized path's abs_pos accounting
                # (prompt tokens + every generated token incl. EOS).
                session.abs_pos = start + len(tokens) + len(req.output)
        finally:
            if session is not None:
                session.lock.release()
        response = api_response("".join(pieces), finished=True)
        response["usageMetadata"] = {
            "promptTokenCount": len(tokens),
            "candidatesTokenCount": generated,
            "totalTokenCount": len(tokens) + generated,
        }
        if session_id:
            response["sessionId"] = session_id
        return response

    def get_or_create_session(self, session_id: str) -> Session:
        with self.sessions_lock:
            now = time.monotonic()
            expired = [k for k, s in self.sessions.items()
                       if now - s.last_access > SESSION_EXPIRY_S]
            for k in expired:
                del self.sessions[k]
            if session_id not in self.sessions:
                # A continuous server's sessions take the batcher's slot
                # layout, which submit requires.
                self.sessions[session_id] = Session(
                    self.batcher.session_cache() if self.batcher is not None
                    else self.gemma.new_cache(1, self.gemma.runtime.seq_len))
            s = self.sessions[session_id]
            s.last_access = now
            return s

    def wrap_messages(self, contents) -> str:
        """WrapMessagesWithTurnMarkers (api_server.cc:110-137)."""
        prompt = []
        for content in contents:
            role = content.get("role", "")
            for part in content.get("parts", []):
                text = part.get("text")
                if text is None:
                    continue
                if role in ("user", ""):
                    prompt.append(
                        f"<start_of_turn>user\n{text}\n<start_of_turn>model\n")
                elif role == "model":
                    prompt.append(text + "\n")
        return "".join(prompt)

    def generate(self, request: dict, on_chunk=None) -> dict:
        """Run one generateContent request; stream chunks via on_chunk."""
        if "contents" not in request:
            raise ValueError("Missing 'contents' field")
        if self.batcher is not None:
            return self._generate_continuous(request, on_chunk=on_chunk)
        session_id = request.get("sessionId") or f"session_{uuid.uuid4().hex}"
        prompt = self.wrap_messages(request["contents"])

        gen_cfg = request.get("generationConfig", {})
        max_tokens = int(gen_cfg.get("maxOutputTokens", 8192))
        temperature = float(gen_cfg.get("temperature", 1.0))
        top_k = int(gen_cfg.get("topK", 1))

        with self.inference_lock:
            session = self.get_or_create_session(session_id)
            gemma = self.gemma
            old_t, old_k = gemma.runtime.temperature, gemma.runtime.top_k
            gemma.runtime.temperature, gemma.runtime.top_k = temperature, top_k
            try:
                tokens = wrap_and_tokenize(
                    gemma.tokenizer, gemma.chat_template,
                    gemma.config.wrapping, session.abs_pos, prompt)
                start = session.abs_pos
                pieces: list[str] = []

                def stream_token(qi, pos, token, prob):
                    session.abs_pos += 1
                    if session.abs_pos - start <= len(tokens):
                        return True
                    if gemma.config.is_eos(token):
                        return True
                    text = gemma.tokenizer.decode([token])
                    pieces.append(text)
                    if on_chunk is not None:
                        on_chunk(text)
                    return True

                gemma.engine.generate(
                    tokens, max_generated_tokens=max_tokens,
                    stream_token=stream_token, cache=session.cache,
                    start_pos=start,
                )
            finally:
                gemma.runtime.temperature, gemma.runtime.top_k = old_t, old_k

        text = "".join(pieces)
        response = api_response(text, finished=True)
        response["usageMetadata"] = {
            "promptTokenCount": len(tokens),
            "candidatesTokenCount": session.abs_pos - start - len(tokens),
            "totalTokenCount": session.abs_pos,
        }
        response["sessionId"] = session_id
        return response


def api_response(text: str, finished: bool) -> dict:
    """CreateAPIResponse (api_server.cc:165-183)."""
    out = {
        "candidates": [{
            "content": {"parts": [{"text": text}], "role": "model"},
            "index": 0,
        }]
    }
    if finished:
        out["candidates"][0]["finishReason"] = "STOP"
    return out


def make_handler(service: GemmaService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quieter default
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/v1beta/models":
                self._json(200, {"models": [{
                    "name": f"models/{service.model_name}",
                    "displayName": service.gemma.config.display_name,
                    "supportedGenerationMethods": [
                        "generateContent", "streamGenerateContent"],
                }]})
            elif self.path == "/health":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": {"message": "Not found"}})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                request = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._json(400, {"error": {"message": f"JSON parsing error: {e}"}})
                return
            path = self.path.split("?")[0]
            try:
                if path.endswith(":generateContent"):
                    self._json(200, service.generate(request))
                elif path.endswith(":streamGenerateContent"):
                    self._stream(request)
                else:
                    self._json(404, {"error": {"message": "Not found"}})
            except ValueError as e:
                self._json(400, {"error": {"message": str(e)}})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": {"message": f"Server error: {e}"}})

        def _stream(self, request: dict) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(obj: dict) -> None:
                data = f"data: {json.dumps(obj)}\r\n\r\n".encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def on_chunk(text: str) -> None:
                send_chunk(api_response(text, finished=False))

            final = service.generate(request, on_chunk=on_chunk)
            send_chunk(final)
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="gemma_tpu_torch API server")
    add_args(parser, LoaderArgs, InferenceArgs)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--continuous", action="store_true",
                        help="continuous batching: concurrent requests — "
                             "including sessionId follow-ups, whose KV "
                             "caches are adopted into slots — share decode "
                             "steps")
    ns = parser.parse_args(argv)
    loader = extract(ns, LoaderArgs)
    inference = extract(ns, InferenceArgs)
    if not loader.weights:
        parser.error("--weights is required")

    gemma = load_gemma(loader, inference)
    service = GemmaService(gemma,
                           model_name=gemma.config.display_name or "gemma",
                           continuous=ns.continuous)
    server = ThreadingHTTPServer((ns.host, ns.port), make_handler(service))
    print(f"gemma_tpu_torch API server listening on http://{ns.host}:{ns.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
