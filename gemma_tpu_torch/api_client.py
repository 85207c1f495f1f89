"""CLI HTTP/SSE client (counterpart of gemma_tpu/api_client.py; reference
gemma/api_client.cc).  Only the standard library.

Targets a local gemma_tpu_torch api_server or the public Gemini API (with
--api_key), mirroring ClientArgs (gemma/gemma_args.h:267-294).

    python -m gemma_tpu_torch.api_client --prompt "Hi" [--server http://...:8000]
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def build_request(prompt: str, session_id: str | None,
                  temperature: float, top_k: int, max_tokens: int) -> dict:
    req = {
        "contents": [{"role": "user", "parts": [{"text": prompt}]}],
        "generationConfig": {
            "temperature": temperature,
            "topK": top_k,
            "maxOutputTokens": max_tokens,
        },
    }
    if session_id:
        req["sessionId"] = session_id
    return req


def iter_sse(resp):
    """Yield JSON payloads from an SSE byte stream."""
    buf = b""
    while True:
        chunk = resp.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\r\n\r\n" in buf or b"\n\n" in buf:
            sep = b"\r\n\r\n" if b"\r\n\r\n" in buf else b"\n\n"
            event, buf = buf.split(sep, 1)
            for line in event.splitlines():
                if line.startswith(b"data: "):
                    payload = line[len(b"data: "):]
                    if payload.strip() == b"[DONE]":
                        return
                    yield json.loads(payload)


def extract_text(obj: dict) -> str:
    try:
        return obj["candidates"][0]["content"]["parts"][0]["text"]
    except (KeyError, IndexError):
        return ""


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="gemma_tpu_torch API client")
    p.add_argument("--server", default="http://127.0.0.1:8000")
    p.add_argument("--model", default="gemma")
    p.add_argument("--prompt", required=True)
    p.add_argument("--session_id", default="")
    p.add_argument("--api_key", default="",
                   help="Use the public Gemini API with this key")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=1)
    p.add_argument("--max_tokens", type=int, default=2048)
    p.add_argument("--stream", action="store_true", default=True)
    p.add_argument("--no-stream", dest="stream", action="store_false")
    ns = p.parse_args(argv)

    if ns.api_key:
        base = "https://generativelanguage.googleapis.com"
        model = ns.model if ns.model != "gemma" else "gemini-2.0-flash"
        suffix = f"?key={ns.api_key}"
    else:
        base, model, suffix = ns.server, ns.model, ""
    verb = "streamGenerateContent" if ns.stream else "generateContent"
    url = f"{base}/v1beta/models/{model}:{verb}{suffix}"

    body = json.dumps(build_request(
        ns.prompt, ns.session_id or None, ns.temperature, ns.top_k,
        ns.max_tokens)).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})

    with urllib.request.urlopen(req) as resp:
        if ns.stream:
            for obj in iter_sse(resp):
                text = extract_text(obj)
                print(text, end="", flush=True)
                if obj.get("candidates", [{}])[0].get("finishReason"):
                    break
            print()
        else:
            obj = json.loads(resp.read())
            print(extract_text(obj))


if __name__ == "__main__":
    main()
