"""The port's gRPC messages (``cosyvoice2_eu_torch/serving/proto.py``): built
in the process from a written-out descriptor, held to protoc's descriptor of
``PROTO_DEFINITION`` and to the JAX package's messages on the wire; safe
when several processes build them at once, and when the JAX package's
generated ``cosyvoice_pb2`` lives in the same process."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from cosyvoice2_eu_torch.serving import proto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
needs_protoc = pytest.mark.skipif(shutil.which("protoc") is None, reason="needs the system protoc")


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def _descriptor_hex(pb2) -> str:
    from google.protobuf import descriptor_pb2

    fdp = descriptor_pb2.FileDescriptorProto()
    pb2.Request.DESCRIPTOR.file.CopyToProto(fdp)
    return fdp.SerializeToString().hex()


CONCURRENT_CHILD = textwrap.dedent("""
    import sys
    from google.protobuf import descriptor_pb2
    from cosyvoice2_eu_torch.serving.proto import build_messages
    print("ready", flush=True)
    sys.stdin.readline()  # the parent releases every process at once
    built = [build_messages() for _ in range(3)]
    assert all(b is built[0] for b in built)
    fdp = descriptor_pb2.FileDescriptorProto()
    built[0].Request.DESCRIPTOR.file.CopyToProto(fdp)
    print(fdp.SerializeToString().hex(), flush=True)
""")


def test_build_messages_concurrent_processes():
    """8 fresh processes, released together, each build the messages 3
    times: every call succeeds and every process holds the same descriptor
    (the protoc-and-reload build raised ``duplicate file name`` here)."""
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_CHILD], cwd=REPO, env=_env(),
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(8)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready", p.stderr.read()
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 8, [err for _, err in outs]
    got = {out.strip() for out, _ in outs}
    assert got == {proto.file_descriptor_proto().SerializeToString().hex()}


def test_build_messages_writes_nothing(monkeypatch):
    """A build opens no file, starts no process, reloads no module, and
    leaves ``sys.path``, ``sys.modules`` and the default pool as it found
    them."""
    import builtins
    import importlib

    from google.protobuf import descriptor_pool

    def refuse(*args, **kwargs):
        raise AssertionError(f"build_messages called {args[:1]}")

    for mod, name in ((builtins, "open"), (subprocess, "run"), (subprocess, "Popen"),
                      (importlib, "reload"), (os, "makedirs")):
        monkeypatch.setattr(mod, name, refuse)
    path, had = list(sys.path), sys.modules.get("cosyvoice_pb2")
    pb2 = proto.build_messages.__wrapped__()  # past the per-process cache
    assert sys.path == path and sys.modules.get("cosyvoice_pb2") is had
    pool = pb2.Request.DESCRIPTOR.file.pool
    assert pool is not descriptor_pool.Default()
    assert proto.build_messages() is proto.build_messages()


@needs_protoc
def test_descriptor_equals_protoc(tmp_path):
    """The written-out descriptor is what ``protoc --descriptor_set_out``
    makes of ``PROTO_DEFINITION``: ``PROTO_DEFINITION`` stays the source."""
    from google.protobuf import descriptor_pb2

    (tmp_path / "cosyvoice.proto").write_text(proto.PROTO_DEFINITION)
    subprocess.run(["protoc", f"-I{tmp_path}", f"--descriptor_set_out={tmp_path / 'd.pb'}",
                    str(tmp_path / "cosyvoice.proto")], check=True, timeout=60)
    want = descriptor_pb2.FileDescriptorSet.FromString((tmp_path / "d.pb").read_bytes()).file
    assert len(want) == 1
    assert proto.file_descriptor_proto() == want[0]
    assert _descriptor_hex(proto.build_messages()) == want[0].SerializeToString().hex()


def _fields(rng, pb2_message_type) -> dict:
    """Every field of a scalar message set to a non-default value."""
    out = {}
    for f in pb2_message_type.DESCRIPTOR.fields:
        if f.type == f.TYPE_BYTES:
            out[f.name] = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
        else:
            out[f.name] = f"{f.name} é ß {int(rng.integers(1 << 30))}"
    return out


@needs_protoc
@pytest.mark.parametrize("payload", ["sft_request", "zero_shot_request", "cross_lingual_request",
                                     "instruct_request", "Response"])
def test_messages_match_jax_on_the_wire(payload, tmp_path):
    """Equal fields give equal bytes in the port and the JAX package, and
    each side parses the other's."""
    from cosyvoice2_eu_tpu.serving import proto as jax_proto

    path, had = list(sys.path), sys.modules.get("cosyvoice_pb2")
    try:
        jax_pb2 = jax_proto.build_messages(tmp_dir=str(tmp_path))
    finally:  # the JAX package's build edits both; give them back
        sys.path[:] = path
        if had is None:
            sys.modules.pop("cosyvoice_pb2", None)
        else:
            sys.modules["cosyvoice_pb2"] = had
    pb2 = proto.build_messages()
    rng = np.random.default_rng(sum(map(ord, payload)))
    if payload == "Response":
        kw = _fields(rng, pb2.Response)
        ours, theirs = pb2.Response(**kw), jax_pb2.Response(**kw)
    else:
        inner = pb2.Request.DESCRIPTOR.fields_by_name[payload].message_type.name
        kw = _fields(rng, getattr(pb2, inner))
        ours = pb2.Request(**{payload: getattr(pb2, inner)(**kw)})
        theirs = jax_pb2.Request(**{payload: getattr(jax_pb2, inner)(**kw)})
    data = ours.SerializeToString()
    assert data and data == theirs.SerializeToString()
    assert type(theirs).FromString(data) == theirs
    back = type(ours).FromString(theirs.SerializeToString())
    assert back == ours
    if payload != "Response":
        assert back.WhichOneof("RequestPayload") == payload


ORDER_CHILD = textwrap.dedent("""
    import sys
    from google.protobuf import descriptor_pool

    def port():
        from cosyvoice2_eu_torch.serving.proto import build_messages
        path, had = list(sys.path), sys.modules.get("cosyvoice_pb2")
        pb2 = build_messages()
        assert sys.path == path, "the port's build touched sys.path"
        assert sys.modules.get("cosyvoice_pb2") is had, "the port's build touched cosyvoice_pb2"
        return pb2

    def jax():
        from cosyvoice2_eu_tpu.serving.proto import build_messages
        return build_messages(tmp_dir=sys.argv[2])

    if sys.argv[1] == "port_first":
        ours = port()
        assert "cosyvoice_pb2" not in sys.modules
        try:
            descriptor_pool.Default().FindFileByName("cosyvoice.proto")
            raise AssertionError("the port registered cosyvoice.proto in the default pool")
        except KeyError:
            pass
        theirs = jax()
    else:
        theirs = jax()
        ours = port()
    assert theirs is sys.modules["cosyvoice_pb2"]
    assert ours.Request is not theirs.Request and ours.Response is not theirs.Response
    assert ours.Request.DESCRIPTOR.file.pool is not descriptor_pool.Default()
    assert theirs.Request.DESCRIPTOR.file.pool is descriptor_pool.Default()
    req = ours.Request(sft_request=ours.sftRequest(spk_id="a", tts_text="b"))
    assert theirs.Request.FromString(req.SerializeToString()).sft_request.tts_text == "b"
    print("ok")
""")


@needs_protoc
@pytest.mark.parametrize("order", ["port_first", "jax_first"])
def test_both_packages_build_in_one_process(order, tmp_path):
    """The port's messages and the JAX package's generated module in one
    fresh process, in either order: no clash, the port leaves no
    ``cosyvoice_pb2`` and its classes are its own."""
    res = subprocess.run([sys.executable, "-c", ORDER_CHILD, order, str(tmp_path)], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
