"""OpenAI-compatible HTTP server over the port's continuous-batching engine.

Counterpart of ``chatts_tpu/serve/server.py``, with the same HTTP surface and
schema: ``/v1/chat/completions`` takes message content parts
``{"type": "text", "text": ...}`` and ``{"timeseries": [...]}``, applies the
Qwen chat template and serves completions with optional SSE streaming;
``/v1/completions``, ``/v1/models``, ``/health`` and ``/metrics`` as there.
The reference module imports the JAX scheduler, so this is a copy over
``chatts_tpu_torch.serve.scheduler``.

stdlib only (ThreadingHTTPServer).
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine

DEFAULT_MODEL_NAME = "chatts"  # reference server model name (vllm_api.py:43)


def apply_qwen_chat_template(messages: List[Dict[str, Any]]) -> Tuple[str, List[np.ndarray]]:
    """Assemble the Qwen chat format and collect timeseries content parts in
    prompt order (reference template assembly: vllm_stream_qa.py:91-94,
    inference_tsmllm_deepspeed.py:133)."""
    series: List[np.ndarray] = []
    parts: List[str] = []
    has_system = any(m.get("role") == "system" for m in messages)
    if not has_system:
        parts.append(
            "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        )
    for msg in messages:
        role = msg.get("role", "user")
        content = msg.get("content", "")
        if isinstance(content, str):
            text = content
        else:
            text = ""
            for item in content:
                if "timeseries" in item:
                    series.append(np.asarray(item["timeseries"], dtype=np.float64))
                    text += "<ts><ts/>"
                elif item.get("type") == "text" or "text" in item:
                    text += item.get("text", "")
        parts.append(f"<|im_start|>{role}\n{text}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts), series


class ChatTSServer:
    def __init__(
        self,
        engine: ServeEngine,
        tokenizer,
        model_name: str = DEFAULT_MODEL_NAME,
        host: str = "0.0.0.0",
        port: int = 12345,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def _handle_chat(self, body: dict, handler: "_Handler") -> None:
        messages = body.get("messages", [])
        prompt, series = apply_qwen_chat_template(messages)
        params = SamplingParams(
            max_tokens=int(body.get("max_tokens", 512)),
            temperature=float(body.get("temperature", 0.2)),
            top_p=float(body.get("top_p", 1.0)),
        )
        self._run_request(prompt, series, params, body, handler, chat=True)

    def _handle_completions(self, body: dict, handler: "_Handler") -> None:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        series = [np.asarray(t, dtype=np.float64) for t in body.get("timeseries", [])]
        params = SamplingParams(
            max_tokens=int(body.get("max_tokens", 512)),
            temperature=float(body.get("temperature", 0.2)),
            top_p=float(body.get("top_p", 1.0)),
        )
        self._run_request(prompt, series, params, body, handler, chat=False)

    def _run_request(self, prompt, series, params, body, handler, chat: bool):
        stream = bool(body.get("stream", False))
        req = Request(prompt, series, params)
        self.engine.submit(req)
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        if stream:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.end_headers()
            while True:
                chunk = req.stream_queue.get()
                if chunk is None:
                    break
                delta = self.tokenizer.decode(chunk, skip_special_tokens=True)
                payload = self._chunk_payload(
                    completion_id, created, delta, chat, finish=None
                )
                handler.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                handler.wfile.flush()
            if req.error:
                err_payload = {"error": {"message": req.error}}
                handler.wfile.write(f"data: {json.dumps(err_payload)}\n\n".encode())
            final = self._chunk_payload(
                completion_id, created, "", chat, finish=req.finish_reason or "stop"
            )
            handler.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
            return

        # Non-streaming: wait for completion.
        while req.finished_s is None and req.error is None:
            time.sleep(0.005)
        if req.error:
            handler.send_json(400, {"error": {"message": req.error}})
            return
        text = self.tokenizer.decode(req.output_tokens, skip_special_tokens=True)
        usage = {
            "prompt_tokens": req.prompt_tokens,
            "completion_tokens": len(req.output_tokens),
            "total_tokens": req.prompt_tokens + len(req.output_tokens),
        }
        if chat:
            payload = {
                "id": completion_id,
                "object": "chat.completion",
                "created": created,
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": req.finish_reason or "stop",
                    }
                ],
                "usage": usage,
            }
        else:
            payload = {
                "id": completion_id,
                "object": "text_completion",
                "created": created,
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "text": text,
                        "finish_reason": req.finish_reason or "stop",
                    }
                ],
                "usage": usage,
            }
        handler.send_json(200, payload)

    def _chunk_payload(self, cid, created, delta, chat, finish):
        if chat:
            return {
                "id": cid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "delta": {"content": delta} if delta else {},
                        "finish_reason": finish,
                    }
                ],
            }
        return {
            "id": cid,
            "object": "text_completion",
            "created": created,
            "model": self.model_name,
            "choices": [{"index": 0, "text": delta, "finish_reason": finish}],
        }

    # ------------------------------------------------------------------

    def serve_forever(self):
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def send_json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self.send_json(200, {"status": "ok"})
                elif self.path == "/metrics":
                    self.send_json(200, server.engine.stats())
                elif self.path == "/v1/models":
                    self.send_json(
                        200,
                        {
                            "object": "list",
                            "data": [
                                {
                                    "id": server.model_name,
                                    "object": "model",
                                    "owned_by": "chatts_tpu",
                                }
                            ],
                        },
                    )
                else:
                    self.send_json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self.send_json(400, {"error": {"message": "invalid JSON"}})
                    return
                try:
                    if self.path == "/v1/chat/completions":
                        server._handle_chat(body, self)
                    elif self.path == "/v1/completions":
                        server._handle_completions(body, self)
                    else:
                        self.send_json(404, {"error": {"message": "not found"}})
                except BrokenPipeError:
                    pass
                except Exception as err:
                    try:
                        self.send_json(500, {"error": {"message": str(err)}})
                    except Exception:
                        pass

        self.engine.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.serve_forever()

    def start_background(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        # Wait for the socket to come up.
        deadline = time.time() + 10
        while self._httpd is None and time.time() < deadline:
            time.sleep(0.05)

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        self.engine.stop()
