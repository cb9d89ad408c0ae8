"""The gRPC service's messages, in the port.

Counterpart of ``cosyvoice2_eu_tpu/serving/proto.py``, after the reference's
``cosyvoice.proto``: a server-streaming ``Inference`` RPC whose request
carries one of {sft, zero_shot, cross_lingual, instruct} and whose responses
stream int16 PCM chunks, field numbers as the reference's.
"""

from __future__ import annotations

PROTO_DEFINITION = """
syntax = "proto3";
package cosyvoice;

service CosyVoice {
  rpc Inference(Request) returns (stream Response) {}
}

message Request {
  oneof RequestPayload {
    sftRequest sft_request = 1;
    zeroshotRequest zero_shot_request = 2;
    crosslingualRequest cross_lingual_request = 3;
    instructRequest instruct_request = 4;
  }
}

message sftRequest {
  string spk_id = 1;
  string tts_text = 2;
}

message zeroshotRequest {
  string tts_text = 1;
  string prompt_text = 2;
  bytes prompt_audio = 3;
}

message crosslingualRequest {
  string tts_text = 1;
  bytes prompt_audio = 2;
}

message instructRequest {
  string tts_text = 1;
  string spk_id = 2;
  string instruct_text = 3;
}

message Response {
  bytes tts_audio = 1;
}
"""

SERVICE_NAME = "cosyvoice.CosyVoice"
METHOD = "Inference"


def build_messages(tmp_dir: str | None = None):
    """The message classes, generated by the system ``protoc`` into
    ``tmp_dir`` (default: ``cosyvoice2_eu_torch_proto`` under the temp
    directory) and imported.  Messages only: the service plumbing is
    written by hand in ``grpc_server.py``."""
    import importlib
    import os
    import subprocess
    import sys
    import tempfile

    tmp_dir = tmp_dir or os.path.join(tempfile.gettempdir(), "cosyvoice2_eu_torch_proto")
    os.makedirs(tmp_dir, exist_ok=True)
    proto_path = os.path.join(tmp_dir, "cosyvoice.proto")
    with open(proto_path, "w") as f:
        f.write(PROTO_DEFINITION)
    subprocess.run(["protoc", f"-I{tmp_dir}", f"--python_out={tmp_dir}", proto_path], check=True)
    if tmp_dir not in sys.path:
        sys.path.insert(0, tmp_dir)
    mod = importlib.import_module("cosyvoice_pb2")
    importlib.reload(mod)
    return mod
