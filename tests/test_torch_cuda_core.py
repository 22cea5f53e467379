"""The paddle-style core on the card: golden cases on CUDA, CUDA-graph
capture of op-layer calls, and ``F.flash_attention`` on Tensors through
the kernels. Every test here is marked ``cuda`` and skips without a GPU.

This file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_core.py

Tolerances: the golden tables' own (float64); flash on Tensors against the
same kernels called on the bare torch tensors, bit for bit (the seam only
wraps and unwraps).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch import testing as T
from paddle_tpu_torch.framework import device as pdev

HERE = os.path.dirname(os.path.abspath(__file__))
SOME = ("exp", "add_broadcast", "sum_axis", "cumsum_axis", "topk", "where",
        "reshape", "concat", "gather", "matmul_batched", "einsum_batch",
        "cholesky", "solve", "det", "logsumexp_axis", "masked_fill")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    prev = pdev._current["place"]
    P.set_device("gpu:0")
    yield torch.device("cuda")
    pdev._current["place"] = prev


def _cases():
    tables = T.load_tables(HERE, P, P.nn.functional)
    specs = {c["id"]: c for t in tables.values() for c in t}
    return [specs[i] for i in SOME]


@pytest.mark.cuda
def test_golden_cases_on_cuda_eager_and_grad(cuda):
    for spec in _cases():
        opts = spec["opts"]
        inputs = spec["inputs"]()
        got = spec["fn"](*[P.to_tensor(np.copy(a)) for a in inputs])
        assert all(t._value.is_cuda for t in T.leaves(got)), spec["id"]
        T.compare(got, spec["ref"](*[np.copy(a) for a in inputs]),
                  opts.get("rtol", 1e-6), opts.get("atol", 1e-8), spec["id"])
        if opts.get("check_grad", True):
            idx = [i for i, a in enumerate(inputs)
                   if np.issubdtype(np.asarray(a).dtype, np.floating)]
            if idx:
                T.check_grad(spec["id"], spec["fn"], spec["ref"], inputs, {},
                             idx, opts.get("grad_rtol", 5e-4),
                             opts.get("grad_atol", 1e-6),
                             opts.get("grad_eps", 1e-5),
                             opts.get("grad_samples", 6), P.to_tensor)


@pytest.mark.cuda
def test_op_layer_calls_capture_and_replay_bit_equal(cuda):
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        for spec in _cases():
            if not spec["opts"].get("check_jit", True):
                continue
            ins = [P.to_tensor(a) for a in spec["inputs"]()]
            eager = spec["fn"](*ins)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                spec["fn"](*ins)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = spec["fn"](*ins)
            g.replay()
            torch.cuda.synchronize()
            for a, b in zip(T.leaves(out), T.leaves(eager)):
                assert torch.equal(a._value, b._value), spec["id"]
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_on_tensors_runs_the_kernels(cuda, dtype):
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(3)
    raw = [torch.randn((2, 256, 4, 64), generator=g, device=cuda)
           .to(getattr(torch, dtype)) for _ in range(3)]
    ts = [P.to_tensor(r, stop_gradient=False) for r in raw]
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    out, _ = P.nn.functional.flash_attention(*ts, causal=True)
    assert isinstance(out, P.Tensor) and not out.stop_gradient
    out.sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    bare = [r.detach().clone().requires_grad_(True) for r in raw]
    ref, _ = P.nn.functional.flash_attention(*bare, causal=True)
    ref.sum().backward()
    assert torch.equal(out._value, ref)
    for t, b in zip(ts, bare):
        assert torch.equal(t.grad._value, b.grad)


@pytest.mark.cuda
def test_to_tensor_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = pdev._current["place"]
    pdev._current["place"] = None
    try:
        assert P.to_tensor([1.0]).place.is_gpu_place()
        assert P.get_device() == "gpu:0"
        assert P.to_tensor([1.0], place="cpu").place.is_cpu_place()
    finally:
        pdev._current["place"] = prev


@pytest.mark.cuda
def test_measured_body_peak_reads_the_allocator_on_a_program_of_known_size(
        cuda):
    """``analysis.hbm.measure_body_peak`` on a step program whose body
    holds one 4 MiB temporary (its first row is copied out, so no aten
    workspace joins it): the allocator's rise across the eager body is
    exactly that temporary, the reader adds the argument bytes it is
    given, and the static estimate of the same body counts the same 4
    MiB. A column sum instead allocates an 8 MiB workspace inside the
    operator, which the allocator sees and no graph shows."""
    from paddle_tpu_torch.analysis import hbm
    from paddle_tpu_torch.analysis.core import trace
    from paddle_tpu_torch.jit.graphs import StepRunner

    def body(inp, out):
        t = inp["x"] * 2.0                       # [1024, 1024] f32: 4 MiB
        out["y"].copy_(t[0])

    def summed(inp, out):
        out["y"].copy_((inp["x"] * 2.0).sum(0))

    spec = ({"x": ((1024, 1024), torch.float32)},
            {"y": ((1024,), torch.float32)})
    run = StepRunner("cuda", *spec, {"step": body, "summed": summed})
    run.fill(x=np.ones((1024, 1024), np.float32))
    run.run("step")                              # first run and capture
    run.run("summed")
    torch.cuda.synchronize()
    temp = 4 << 20
    got = hbm.measure_body_peak(run, argument_bytes=0)
    assert got == temp
    assert hbm.measure_body_peak(run, argument_bytes=123) == temp + 123
    est = hbm.estimate_peak(trace(body, dict(run.inputs.dev),
                                  dict(run.outputs.dev)))
    assert est.peak_bytes - est.argument_bytes == temp
    assert hbm.measure_body_peak(run, "summed") > 2 * temp
    assert np.allclose(run.read()["y"], 2048.0)
