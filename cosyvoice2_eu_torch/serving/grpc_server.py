"""gRPC streaming TTS server, in the port.

Counterpart of ``cosyvoice2_eu_tpu/serving/grpc_server.py``, after the
reference's gRPC server: a server-streaming ``Inference`` RPC whose
responses carry raw int16 PCM chunks.  The service is registered with
generic method handlers, wire-compatible with the reference's generated
stubs.  Needs ``grpcio``; the messages are built in the process (``proto.py``).

    python -m cosyvoice2_eu_torch.serving.grpc_server --model-dir DIR --device cuda

``--tp N`` under ``torchrun`` serves an LM split over N processes through
the engine (``EngineAPI``, 4 slots): process 0 binds the port, the others
follow its LM calls until it closes.
"""

from __future__ import annotations

import logging
from concurrent import futures

import numpy as np

from cosyvoice2_eu_torch.serving.http_server import _pcm16
from cosyvoice2_eu_torch.serving.proto import METHOD, SERVICE_NAME, build_messages

log = logging.getLogger(__name__)


class CosyVoiceServicer:
    def __init__(self, model):
        from cosyvoice2_eu_torch.serving.engine import check_servable

        check_servable(model)
        self.model = model
        self.pb2 = build_messages()

    def Inference(self, request, context):
        pb2 = self.pb2
        which = request.WhichOneof("RequestPayload")
        if which == "zero_shot_request":
            r = request.zero_shot_request
            prompt = np.frombuffer(r.prompt_audio, np.int16).astype(np.float32) / 32768.0
            gen = self.model.stream(r.tts_text, prompt, prompt_text=r.prompt_text,
                                    mode="zero_shot")
        elif which == "cross_lingual_request":
            r = request.cross_lingual_request
            prompt = np.frombuffer(r.prompt_audio, np.int16).astype(np.float32) / 32768.0
            gen = self.model.stream(r.tts_text, prompt, mode="cross_lingual")
        elif which == "sft_request":
            r = request.sft_request
            gen = self.model.stream(r.tts_text, self.model._frontend.get_spk(r.spk_id))
        elif which == "instruct_request":
            r = request.instruct_request
            gen = self.model.stream(r.tts_text, self.model._frontend.get_spk(r.spk_id),
                                    mode="cross_lingual")
        else:
            context.abort(3, f"unknown request payload {which}")
            return
        for chunk in gen:
            yield pb2.Response(tts_audio=_pcm16(chunk[0]))


def serve(model, host: str = "0.0.0.0", port: int = 50000, max_workers: int = 4):
    """Start the server; returns (server, the port it bound: a free one for port 0)."""
    import grpc

    pb2 = build_messages()
    servicer = CosyVoiceServicer(model)
    handlers = {
        METHOD: grpc.unary_stream_rpc_method_handler(
            servicer.Inference,
            request_deserializer=pb2.Request.FromString,
            response_serializer=pb2.Response.SerializeToString,
        )
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE_NAME,
                                                                          handlers),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    log.info("gRPC server listening on %s:%d", host, bound)
    return server, bound


def make_client_stub(channel):
    """Wire-compatible stand-in for the generated ``CosyVoiceStub``: (Stub, pb2)."""
    pb2 = build_messages()
    call = channel.unary_stream(
        f"/{SERVICE_NAME}/{METHOD}",
        request_serializer=pb2.Request.SerializeToString,
        response_deserializer=pb2.Response.FromString,
    )

    class Stub:
        Inference = staticmethod(call)

    return Stub, pb2


def main():
    import argparse

    from cosyvoice2_eu_torch.serving.engine import follows, serving_api
    from cosyvoice2_eu_torch.serving.http_server import load_for_serving

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=50000)
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--max-conc", type=int, default=4)
    parser.add_argument("--tp", type=int, default=0,
                        help="split the LM over N processes (torchrun)")
    args = parser.parse_args()
    model = serving_api(load_for_serving(args))
    if follows(model):
        return
    server, _ = serve(model, port=args.port, max_workers=args.max_conc)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
