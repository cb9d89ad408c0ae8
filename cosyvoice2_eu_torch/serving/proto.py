"""The gRPC service's messages, in the port.

Counterpart of ``cosyvoice2_eu_tpu/serving/proto.py``, after the reference's
``cosyvoice.proto``: a server-streaming ``Inference`` RPC whose request
carries one of {sft, zero_shot, cross_lingual, instruct} and whose responses
stream int16 PCM chunks, field numbers as the reference's.

The messages are built in the process from a descriptor written out below
(equal to what ``protoc`` makes of ``PROTO_DEFINITION``; a test holds them
together) in a private descriptor pool: no ``protoc``, no file, nothing in
``sys.path``, ``sys.modules`` or the default pool, so concurrent processes
and other builders of ``cosyvoice.proto`` in the same process cannot clash.
"""

from __future__ import annotations

import functools
import types

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

# PROTO_DEFINITION's messages in its order: (message, ((field, number, type), ...));
# a type that is not a scalar names a message of the package
MESSAGES = (
    ("Request", (("sft_request", 1, "sftRequest"),
                 ("zero_shot_request", 2, "zeroshotRequest"),
                 ("cross_lingual_request", 3, "crosslingualRequest"),
                 ("instruct_request", 4, "instructRequest"))),
    ("sftRequest", (("spk_id", 1, "string"), ("tts_text", 2, "string"))),
    ("zeroshotRequest", (("tts_text", 1, "string"), ("prompt_text", 2, "string"),
                         ("prompt_audio", 3, "bytes"))),
    ("crosslingualRequest", (("tts_text", 1, "string"), ("prompt_audio", 2, "bytes"))),
    ("instructRequest", (("tts_text", 1, "string"), ("spk_id", 2, "string"),
                         ("instruct_text", 3, "string"))),
    ("Response", (("tts_audio", 1, "bytes"),)),
)
ONEOFS = {"Request": "RequestPayload"}  # every field of these messages lies in the oneof


def _json_name(name: str) -> str:
    head, *parts = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in parts)


def file_descriptor_proto():
    """``PROTO_DEFINITION`` as the ``FileDescriptorProto`` protoc makes of it
    (``protoc --descriptor_set_out``)."""
    from google.protobuf import descriptor_pb2

    fdp = descriptor_pb2.FileDescriptorProto(name="cosyvoice.proto", package="cosyvoice",
                                             syntax="proto3")
    F = descriptor_pb2.FieldDescriptorProto
    scalars = {"string": F.TYPE_STRING, "bytes": F.TYPE_BYTES}
    for message, fields in MESSAGES:
        m = fdp.message_type.add(name=message)
        if message in ONEOFS:
            m.oneof_decl.add(name=ONEOFS[message])
        for name, number, kind in fields:
            f = m.field.add(name=name, number=number, label=F.LABEL_OPTIONAL,
                            json_name=_json_name(name))
            if kind in scalars:
                f.type = scalars[kind]
            else:
                f.type, f.type_name = F.TYPE_MESSAGE, f".cosyvoice.{kind}"
            if message in ONEOFS:
                f.oneof_index = 0
    method = fdp.service.add(name="CosyVoice").method.add(
        name=METHOD, input_type=".cosyvoice.Request", output_type=".cosyvoice.Response",
        server_streaming=True)
    method.options.SetInParent()  # the rpc's empty "{}"
    return fdp


@functools.cache
def build_messages():
    """The message classes, built once per process in a descriptor pool of
    their own.  Messages only: the service plumbing is written by hand in
    ``grpc_server.py``."""
    from google.protobuf import descriptor_pool, message_factory

    pool = descriptor_pool.DescriptorPool()
    pool.Add(file_descriptor_proto())
    return types.SimpleNamespace(**{
        message: message_factory.GetMessageClass(pool.FindMessageTypeByName(f"cosyvoice.{message}"))
        for message, _ in MESSAGES})
