"""The port's servers (tiny config, fp32, CPU): the stdlib HTTP server on
127.0.0.1 plain and through ``EngineAPI``, wav decoding against the JAX
package, the proto messages, the gRPC round trip and the web UI's plain
functions against the JAX package's.

Servers bind an ephemeral port and close in ``finally``; clients carry
socket timeouts and engines close, so no test can block."""

import base64
import http.client
import io
import json
import threading
import wave

import numpy as np
import pytest

import cosyvoice2_eu_torch as cosy
from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.serving import http_server, webui
from cosyvoice2_eu_torch.serving.engine import EngineAPI
from cosyvoice2_eu_tpu.serving import http_server as jax_http
from cosyvoice2_eu_tpu.serving import webui as jax_webui

PCFG = port_tiny()
PCM_TOKEN = 2 * PCFG.hift.upsample_scale * PCFG.flow.token_mel_ratio  # bytes a token: 1920
TIMEOUT = 120


@pytest.fixture(scope="module")
def api():
    """A tiny ``Cosy2EU`` on the CPU whose frontend models are seeded stubs
    (the tiny config has no speech tokenizer or x-vector model, and its flow
    takes 16 mel bins)."""
    api = cosy.load(config=PCFG, seed=0, device="cpu", compute_dtype="float32")
    rng = np.random.default_rng(1)
    fe = api._frontend
    fe.speech_tokenizer_fn = lambda wav: rng.integers(
        0, PCFG.flow.vocab_size, max(len(wav) // 640, 2)).astype(np.int32)
    fe.spk_embedding_fn = lambda wav: rng.standard_normal(192).astype(np.float32)
    fe.mel_fn = lambda wav24: rng.standard_normal(
        (len(wav24) // 480, PCFG.flow.output_size)).astype(np.float32)
    return api


def _wav_bytes(seconds=0.5, sr=16000, channels=1, width=2, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((int(seconds * sr), channels)) * 0.1
    pcm = (x * (32767 if width == 2 else 2147483647)).astype(np.int16 if width == 2 else np.int32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post(port: int, route: str, body: dict) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", route, json.dumps(body))
        resp = conn.getresponse()
        assert resp.status == 200, resp.status
        return resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("engine_slots", [0, 2])
def test_http_round_trip(api, engine_slots):
    """A zero-shot and a cross-lingual POST, then one for a stored speaker,
    each answered with chunked int16 PCM of whole tokens (1920 bytes a
    token), served by the model alone or through ``EngineAPI``."""
    model = api if engine_slots == 0 else EngineAPI(
        api, n_slots=engine_slots, chunk_steps=16, max_cache=256, max_gen=64)
    server = http_server.serve_stdlib(model, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        wav_b64 = base64.b64encode(_wav_bytes()).decode()
        bodies = {
            "/inference_zero_shot": {"tts_text": "bonjour le monde", "prompt_text": "salut",
                                     "prompt_wav_b64": wav_b64},
            "/inference_cross_lingual": {"tts_text": "hallo welt", "prompt_wav_b64": wav_b64},
        }
        for route, body in bodies.items():
            data = _post(port, route, body)
            assert len(data) > 0 and len(data) % PCM_TOKEN == 0, (route, len(data))
        model.add_zero_shot_spk("salut", http_server._decode_wav_bytes(_wav_bytes()), "spk_a")
        data = _post(port, "/inference_sft", {"tts_text": "salut", "spk_id": "spk_a"})
        assert len(data) > 0 and len(data) % PCM_TOKEN == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(TIMEOUT)
        if engine_slots:
            model.close()
    assert not thread.is_alive()


@pytest.mark.parametrize("sr,channels,width", [(16000, 1, 2), (48000, 2, 2), (24000, 1, 4)])
def test_decode_wav_bytes_matches_jax(sr, channels, width):
    data = _wav_bytes(0.3, sr, channels, width, seed=sr)
    got = http_server._decode_wav_bytes(data)
    want = jax_http._decode_wav_bytes(data)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_proto_round_trip():
    from cosyvoice2_eu_torch.serving.proto import build_messages

    pb2 = build_messages()
    req = pb2.Request(zero_shot_request=pb2.zeroshotRequest(
        tts_text="bonjour", prompt_text="salut", prompt_audio=b"\x01\x02"))
    back = pb2.Request.FromString(req.SerializeToString())
    assert back.WhichOneof("RequestPayload") == "zero_shot_request"
    assert back.zero_shot_request.tts_text == "bonjour"
    assert back.zero_shot_request.prompt_audio == b"\x01\x02"


def test_grpc_round_trip(api):
    """A cross-lingual request through the server-streaming RPC: int16 PCM
    chunks of whole tokens."""
    grpc = pytest.importorskip("grpc")
    from cosyvoice2_eu_torch.serving.grpc_server import make_client_stub, serve

    server, port = serve(api, host="127.0.0.1", port=0, max_workers=2)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        Stub, pb2 = make_client_stub(channel)
        pcm = (np.random.default_rng(2).standard_normal(8000) * 3000).astype(np.int16).tobytes()
        req = pb2.Request(cross_lingual_request=pb2.crosslingualRequest(
            tts_text="bonjour le monde", prompt_audio=pcm))
        chunks = [r.tts_audio for r in Stub.Inference(req, timeout=TIMEOUT)]
        assert chunks and sum(len(c) for c in chunks) % PCM_TOKEN == 0
        assert len(b"".join(chunks)) > 0
    finally:
        channel.close()
        server.stop(0)


def test_webui_postprocess_prompt_matches_jax():
    """Silence trimmed, the peak normalised to 0.8, 0.2 s of pad: the JAX
    package's output, on loud, quiet and short prompts."""
    sr = 16000
    rng = np.random.default_rng(0)
    loud = np.concatenate([np.zeros(sr), rng.standard_normal(sr) * 2.0, np.zeros(sr)])
    quiet = np.sin(np.linspace(0, 100, sr)) * 0.1
    for sig in (loud.astype(np.float32), quiet.astype(np.float32), np.ones(300, np.float32)):
        got = webui.postprocess_prompt(sig, sr)
        want = jax_webui.postprocess_prompt(sig, sr)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert abs(np.abs(webui.postprocess_prompt(loud, sr)).max() - webui.MAX_VAL) < 1e-6


def test_webui_validate_request_matches_jax():
    """Every mode against every combination of prompt, transcription,
    instruction and speaker: the JAX package's warnings."""
    assert webui.MODES == jax_webui.MODES and webui.INSTRUCTIONS == jax_webui.INSTRUCTIONS
    for mode in webui.MODES:
        for prompt in (False, True):
            for prompt_text in ("", "bonjour"):
                for instruct in ("", "speak softly"):
                    for spk in ("", "spk"):
                        args = (mode, prompt, prompt_text, instruct, spk)
                        assert webui.validate_request(*args) == jax_webui.validate_request(*args)
