"""Minimal HTTP API for the TTS engine, stdlib only (port of
``vits_tpu/serve/http_api.py``):

  GET  /health            -> {"status": "ok", "sampling_rate": N}
  POST /synthesize        -> audio/wav bytes
        body (JSON): {"text": "[EN]hello[EN]", "speaker_id": 0,
                      "seed": 0, "scope_shift": 0, "duration": 1.0}
        Add "format": "json" for base64 audio + the cleaned IPA instead.

Run:  python -m vits_torch.serve.http_api -c config.yaml [-p generator.pt] --port 8080

Requests are serialized through a lock: the handler threads share one model
on one card and no stream state. For throughput, front this with
`serve.batcher.DynamicBatcher`.
"""

from __future__ import annotations

import base64
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def wav_bytes(sampling_rate: int, audio: np.ndarray) -> bytes:
    """PCM16 WAV encoding (stdlib-only scipy.io.wavfile.write equivalent)."""
    pcm = np.clip(np.asarray(audio, np.float32).reshape(-1), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm16), b"WAVE", b"fmt ", 16, 1, 1,
        sampling_rate, sampling_rate * 2, 2, 16, b"data", len(pcm16),
    )
    return hdr + pcm16


def make_handler(engine, lock: threading.Lock | None = None):
    """Build a request-handler class bound to `engine`.

    `engine` needs `.synthesize(text, speaker_id, seed, scope_shift,
    duration)` returning (ipa, (sr, audio)) and `.sampling_rate`: a
    serve.engine.TTSEngine, or any object with that contract."""
    lock = lock or threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
            if self.path == "/health":
                self._send_json(
                    200,
                    {"status": "ok", "sampling_rate": engine.sampling_rate},
                )
            else:
                self._send_json(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path != "/synthesize":
                self._send_json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
            except (ValueError, KeyError) as e:
                self._send_json(400, {"error": f"bad request: {e!r}"})
                return
            try:
                with lock:
                    ipa, (sr, audio) = engine.synthesize(
                        text,
                        speaker_id=int(req.get("speaker_id", 0)),
                        seed=int(req.get("seed", 0)),
                        scope_shift=int(req.get("scope_shift", 0)),
                        duration=float(req.get("duration", 1.0)),
                    )
            except Exception as e:  # surface synth errors as 500, not a hang
                self._send_json(500, {"error": repr(e)})
                return
            wav = wav_bytes(sr, audio)
            if req.get("format") == "json":
                self._send_json(200, {
                    "ipa": ipa,
                    "sampling_rate": sr,
                    "num_samples": int(np.asarray(audio).size),
                    "wav_base64": base64.b64encode(wav).decode(),
                })
            else:
                self._send(200, wav, "audio/wav")

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(engine, host: str = "0.0.0.0", port: int = 8080):
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    return server


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-p", "--checkpoint", default=None,
                        help="eval_{step} checkpoint or generator state_dict")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default=None, help="default: cuda")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from vits_torch.serve.engine import TTSEngine

    engine = TTSEngine(args.config, args.checkpoint, bf16=args.bf16, device=args.device)
    server = serve(engine, args.host, args.port)
    print(f"vits_torch HTTP API on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
