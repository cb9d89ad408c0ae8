"""HTTP streaming TTS server, in the port.

Counterpart of ``cosyvoice2_eu_tpu/serving/http_server.py``, after the
reference's FastAPI surface: POST ``/inference_zero_shot``,
``/inference_cross_lingual``, ``/inference_sft`` and ``/inference_instruct2``
stream raw int16 PCM at the model's sample rate.  FastAPI serves when it is
installed; otherwise a stdlib ``http.server`` serves the same routes and
wire format, with a JSON body.

    python -m cosyvoice2_eu_torch.serving.http_server --model-dir DIR --engine-slots 4

``--engine-slots N`` serves through the continuous-batching engine
(``EngineAPI``) so that concurrent requests share the LM decode; 0 runs each
request on its own.  ``--device`` defaults to "cuda".  ``--tp N`` serves an
LM split over N processes under ``torchrun``: process 0 binds the port and
the others follow its engine's LM calls until it closes.

    torchrun --nproc-per-node 2 -m cosyvoice2_eu_torch.serving.http_server --tp 2 --engine-slots 4
"""

from __future__ import annotations

import io
import json
import logging
import wave

import numpy as np

log = logging.getLogger(__name__)


def _pcm16(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1, 1) * 32767.0).astype(np.int16).tobytes()


def _decode_wav_bytes(data: bytes, target_sr: int = 16000) -> np.ndarray:
    """A 16- or 32-bit PCM wav file's bytes -> mono float32 at ``target_sr``."""
    from cosyvoice2_eu_torch.frontend.frontend import resample

    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    else:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return resample(x, sr, target_sr)


def _routes(model):
    """Route -> generator of PCM byte chunks, over ``model``'s ``stream``
    (a ``Cosy2EU`` or an ``EngineAPI``; a tensor-parallel model only behind
    an ``EngineAPI``)."""
    from cosyvoice2_eu_torch.serving.engine import check_servable

    check_servable(model)

    def inference_zero_shot(tts_text: str, prompt_text: str, prompt_wav: bytes):
        prompt = _decode_wav_bytes(prompt_wav)
        for chunk in model.stream(tts_text, prompt, prompt_text=prompt_text, mode="zero_shot"):
            yield _pcm16(chunk[0])

    def inference_cross_lingual(tts_text: str, prompt_wav: bytes):
        prompt = _decode_wav_bytes(prompt_wav)
        for chunk in model.stream(tts_text, prompt, mode="cross_lingual"):
            yield _pcm16(chunk[0])

    def inference_sft(tts_text: str, spk_id: str):
        prompt = model._frontend.get_spk(spk_id)
        for chunk in model.stream(tts_text, prompt):
            yield _pcm16(chunk[0])

    def inference_instruct2(tts_text: str, instruct_text: str, prompt_wav: bytes):
        prompt = _decode_wav_bytes(prompt_wav)
        for chunk in model.stream(tts_text, prompt, mode="instruct2",
                                  instruct_text=instruct_text):
            yield _pcm16(chunk[0])

    return {
        "/inference_zero_shot": inference_zero_shot,
        "/inference_cross_lingual": inference_cross_lingual,
        "/inference_sft": inference_sft,
        "/inference_instruct2": inference_instruct2,
    }


def build_fastapi_app(model):
    """The routes as a FastAPI app (form fields, an uploaded prompt wav)."""
    from fastapi import FastAPI, Form, UploadFile
    from fastapi.responses import StreamingResponse

    app = FastAPI()
    routes = _routes(model)

    @app.post("/inference_zero_shot")
    async def zero_shot(tts_text: str = Form(), prompt_text: str = Form(),
                        prompt_wav: UploadFile = None):
        data = await prompt_wav.read()
        return StreamingResponse(routes["/inference_zero_shot"](tts_text, prompt_text, data))

    @app.post("/inference_cross_lingual")
    async def cross_lingual(tts_text: str = Form(), prompt_wav: UploadFile = None):
        data = await prompt_wav.read()
        return StreamingResponse(routes["/inference_cross_lingual"](tts_text, data))

    @app.get("/inference_sft")
    @app.post("/inference_sft")
    async def sft(tts_text: str = Form(), spk_id: str = Form()):
        return StreamingResponse(routes["/inference_sft"](tts_text, spk_id))

    @app.post("/inference_instruct2")
    async def instruct2(tts_text: str = Form(), instruct_text: str = Form(),
                        prompt_wav: UploadFile = None):
        data = await prompt_wav.read()
        return StreamingResponse(routes["/inference_instruct2"](tts_text, instruct_text, data))

    return app


def serve_stdlib(model, host: str = "0.0.0.0", port: int = 50000):
    """The stdlib server (not started: call ``serve_forever``).  Body: JSON
    {tts_text, prompt_text?, instruct_text?, spk_id?, prompt_wav_b64?};
    response: chunked int16 PCM.  Port 0 binds a free port
    (``server.server_address[1]``)."""
    import base64
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    routes = _routes(model)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path not in routes:
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            wav = base64.b64decode(body.get("prompt_wav_b64", "")) or None
            try:
                if self.path == "/inference_zero_shot":
                    gen = routes[self.path](body["tts_text"], body.get("prompt_text", ""), wav)
                elif self.path == "/inference_cross_lingual":
                    gen = routes[self.path](body["tts_text"], wav)
                elif self.path == "/inference_sft":
                    gen = routes[self.path](body["tts_text"], body["spk_id"])
                else:
                    gen = routes[self.path](body["tts_text"], body.get("instruct_text", ""), wav)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for chunk in gen:
                    self.wfile.write(f"{len(chunk):x}\r\n".encode())
                    self.wfile.write(chunk + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except Exception as e:  # the server goes on serving other requests
                log.exception("inference failed")
                self.send_error(500, str(e))

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    log.info("HTTP server listening on %s:%d", *server.server_address[:2])
    return server


def load_for_serving(args):
    """``load(model_dir, device)``, joining the ``torchrun`` process group
    first under ``args.tp`` > 1."""
    import cosyvoice2_eu_torch as cosy

    if args.tp > 1:
        from cosyvoice2_eu_torch.parallel.distributed import init_distributed

        init_distributed(device=args.device)
    return cosy.load(model_dir=args.model_dir, device=args.device, tp=args.tp)


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--engine-slots", type=int, default=0,
        help="serve through the continuous-batching engine with N LM slots "
        "(0 = one request at a time, the reference's behavior; 4 under --tp)")
    parser.add_argument("--tp", type=int, default=0,
                        help="split the LM over N processes (torchrun)")
    args = parser.parse_args()
    from cosyvoice2_eu_torch.serving.engine import follows, serving_api

    model = serving_api(load_for_serving(args), args.engine_slots)
    if follows(model):
        return
    try:
        import uvicorn
    except ImportError:
        serve_stdlib(model, port=args.port).serve_forever()
    else:
        uvicorn.run(build_fastapi_app(model), host="0.0.0.0", port=args.port)


if __name__ == "__main__":
    main()
