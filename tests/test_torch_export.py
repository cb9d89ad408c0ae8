"""Ahead-of-time export in the port (``runtime/export.py``, and K1 as the
operator ``cosyvoice2_eu::flash_attention_fwd``) against the JAX package's
``runtime/export.py`` on the CPU, tiny config.

Tolerances: the saved and reloaded program equals the port's eager
``estimator_forward`` exactly (the same ATen operations); against JAX, fp32
within 1e-4, as ``test_torch_flow.py::test_estimator_matches_jax``.  JAX's
``export_flow_estimator`` fixes bfloat16 arguments, and bfloat16 rounds at
other places in the two frameworks, so the fp32 comparison serializes
JAX's exporter's function at fp32 arguments and calls it through JAX's
``load_exported``; at bfloat16 the two exporters' signatures are compared.
The K1 operator on a CPU tensor is its plain version: exactly
``flash_attention_reference``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy

from cosyvoice2_eu_torch.config import tiny_test_config as port_tiny
from cosyvoice2_eu_torch.models import estimator as port_est
from cosyvoice2_eu_torch.ops import flash_attention as fa
from cosyvoice2_eu_torch.runtime import export as port_export
from cosyvoice2_eu_torch.utils.params import cast_floating, tree_map
from cosyvoice2_eu_tpu.config import tiny_test_config
from cosyvoice2_eu_tpu.models.estimator import estimator_forward as jax_estimator_forward
from cosyvoice2_eu_tpu.models.flow import init_flow
from cosyvoice2_eu_tpu.runtime import export as jax_export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, PCFG = tiny_test_config(), port_tiny()
T = 32


@pytest.fixture(scope="module")
def params():
    jp = init_flow(jax.random.key(0), CFG.flow)
    return jp, tree_map(torch.tensor, to_numpy(jp))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    c = CFG.flow.output_size
    x, mu, cond = (rng.standard_normal((2, c, T)).astype(np.float32) for _ in range(3))
    mask = (np.arange(T)[None, None, :] < np.array([T, 20])[:, None, None]).astype(np.float32)
    return (x, mask, mu, np.array([0.3, 0.7], np.float32),
            rng.standard_normal((2, c)).astype(np.float32), cond)


def test_exported_estimator_equals_eager_and_jax(params, tmp_path):
    """The tiny estimator exported at mel bucket 32, saved and loaded:
    exactly the eager ``estimator_forward``; within 1e-4 of JAX's exported
    program at fp32; the file named as JAX's, ``.pt2`` for ``.jax``."""
    jp, pp = params
    paths = port_export.export_flow_estimator(pp, PCFG.flow, [T], str(tmp_path / "port"))
    assert [os.path.basename(p) for p in paths] == ["flow.estimator.mel32.pt2"]
    program = port_export.load_exported(paths[0])
    args = [torch.tensor(a) for a in _inputs()]
    got = program.module()(pp["estimator"], *args)
    want = port_est.estimator_forward(pp["estimator"], PCFG.flow.estimator, *args)
    assert got.shape == (2, CFG.flow.output_size, T) and torch.equal(got, want)

    def fn(p, x, mask, mu, t, spks, cond):  # export_flow_estimator's, at fp32 arguments
        return jax_estimator_forward(p, CFG.flow.estimator, x, mask, mu, t, spks, cond)

    jargs = [jnp.asarray(a) for a in _inputs()]
    path = tmp_path / "flow.estimator.mel32.jax"
    path.write_bytes(jax.export.export(jax.jit(fn))(jp["estimator"], *jargs).serialize())
    ref = jax_export.load_exported(str(path)).call(jp["estimator"], *jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_export_tts_stages_signature_matches_jax(params, tmp_path):
    """At the served dtype (bfloat16 parameters) ``export_tts_stages``
    writes a program per token bucket at JAX's mel buckets, whose six
    arguments have JAX's shapes and dtypes."""
    from types import SimpleNamespace

    jp, pp = params
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype.kind == "f" else a, jp)
    want = jax_export.export_tts_stages(SimpleNamespace(params={"flow": jb}, cfg=CFG),
                                        str(tmp_path / "jax"), token_buckets=(16,))
    got = port_export.export_tts_stages(
        SimpleNamespace(params={"flow": cast_floating(pp, torch.bfloat16)}, cfg=PCFG),
        str(tmp_path / "port"), token_buckets=(16,))
    assert [os.path.basename(p)[:-4] for p in got] == [os.path.basename(p)[:-4] for p in want]
    jx = jax_export.load_exported(want[0])
    program = port_export.load_exported(got[0])
    specs = [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"][-6:]
    assert [(tuple(s.shape), str(s.dtype).replace("torch.", "")) for s in specs] == \
        [(tuple(a.shape), str(a.dtype)) for a in jx.in_avals[-6:]]
    assert tuple(program.module()(
        cast_floating(pp, torch.bfloat16)["estimator"],
        *[torch.zeros(s.shape, dtype=s.dtype) for s in specs]).shape) == jx.out_avals[0].shape


class _Attention(torch.nn.Module):
    def __init__(self, return_lse: bool):
        super().__init__()
        self.return_lse = return_lse

    def forward(self, q, k, v, lengths):
        return fa.flash_attention(q, k, v, lengths, chunk_size=4, return_lse=self.return_lse)


def _qkv(seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, 2, 8, 64, generator=g) for _ in range(3))
    return q, k, v, torch.tensor([8, 5])


@pytest.mark.parametrize("return_lse", [False, True])
def test_k1_operator_exports_as_one_node_and_loads_in_a_fresh_process(tmp_path, return_lse):
    """A module calling ``flash_attention`` exports to one
    ``cosyvoice2_eu::flash_attention_fwd`` node; a fresh process cannot
    load the file through ``torch.export.load`` alone, but can through
    ``load_exported``, and its output is exactly the plain version's."""
    inputs = _qkv()
    program = torch.export.export(_Attention(return_lse), inputs)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.cosyvoice2_eu.flash_attention_fwd.default) == 1
    assert not any("softmax" in str(t) or "bmm" in str(t) or "matmul" in str(t)
                   for t in targets)
    path, data = tmp_path / "k1.pt2", tmp_path / "inputs.pt"
    torch.export.save(program, str(path))
    torch.save(inputs, str(data))
    code = f"""
import torch
try:
    torch.export.load({str(path)!r})
    print("plain load: no error")
except Exception as e:
    print("plain load:", type(e).__name__)
from cosyvoice2_eu_torch.runtime.export import load_exported
from cosyvoice2_eu_torch.ops.flash_attention import flash_attention_reference
q, k, v, lengths = torch.load({str(data)!r})
got = load_exported({str(path)!r}).module()(q, k, v, lengths)
want = flash_attention_reference(q, k, v, lengths, 4, return_lse={return_lse})
got, want = (got, want) if {return_lse} else ((got,), (want,))
print("equal:", all(torch.equal(a, b) for a, b in zip(got, want)))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "plain load: RuntimeError" in res.stdout and "equal: True" in res.stdout, res.stdout


@pytest.mark.parametrize("return_lse", [False, True])
def test_k1_operator_fake_shapes(return_lse):
    """The operator's fake implementation: o like q, the LSE (B, H, T) fp32
    with ``return_lse``, else an empty fp32 tensor; on real CPU tensors the
    operator gives the plain version and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 3, 10, 64, dtype=torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, q, q, torch.empty(2, dtype=torch.long), 0, 0.125,
                                        return_lse)
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        assert lse.dtype == torch.float32
        assert tuple(lse.shape) == ((2, 3, 10) if return_lse else (0,))
    q, k, v, lengths = _qkv(1)
    before = fa.flash_attention.launches
    o, lse = torch.ops.cosyvoice2_eu.flash_attention_fwd(q, k, v, lengths, 0, 0.125, return_lse)
    want = fa.flash_attention_reference(q, k, v, lengths, 0, 0.125, return_lse=True)
    assert torch.equal(o, want[0]) and fa.flash_attention.launches == before
    if return_lse:
        assert torch.equal(lse, want[1])
