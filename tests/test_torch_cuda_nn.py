"""The nn surface on the card: channels-last convolutions and pools held to
channels-first ones, batch-norm running statistics through a captured
step equal to bodies, and ResNet-18 trained through the captured
``TrainStep`` bit-equal to its bodies; the recurrent layers, the layer
and functional fill-ins and grid sampling against the CPU in f32 and f64
(``tests/nn_fillin_cases.py``, its limits) and captured bit-equal to
eager; q and k of different lengths on the plain route; an LSTM language
model's captured step bit-equal to its body; a GPT-350M-width block under
``auto_cast(level="O2")`` through the flash kernels. Every test here is
marked ``cuda`` and skips without a GPU. This file imports torch, numpy
and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_nn.py

Tolerances: NHWC against NCHW in f32 with TF32 off, 1e-5 of the largest
magnitude (cuDNN sums in another order per layout); replays against
bodies, bit for bit (the same kernels on the same inputs, cuDNN
deterministic).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as pdev
from paddle_tpu_torch.jit import TrainStep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    prev = pdev._current["place"]
    prev_tf32 = torch.backends.cudnn.allow_tf32
    prev_det = torch.backends.cudnn.deterministic
    P.set_device("gpu:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    pdev._current["place"] = prev
    torch.backends.cudnn.allow_tf32 = prev_tf32
    torch.backends.cudnn.deterministic = prev_det


def _close(a, b):
    a, b = a.detach().double(), b.detach().double()
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("stride,padding,groups", [
    (1, 1, 1), (2, 3, 1), (2, "SAME", 1), (1, [0, 1, 1, 0], 1), (1, 1, 4)])
def test_conv2d_nhwc_matches_nchw(cuda, stride, padding, groups):
    F = P.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 8, 17, 17, device="cuda", generator=g)
    w = torch.randn(16, 8 // groups, 3, 3, device="cuda", generator=g)
    b = torch.randn(16, device="cuda", generator=g)
    want = F.conv2d(x, w, b, stride, padding, 1, groups)
    wl = w.contiguous(memory_format=torch.channels_last)
    got = F.conv2d(_nhwc(x), wl, b, stride, padding, 1, groups,
                   data_format="NHWC")
    assert got.is_contiguous()
    _close(got.permute(0, 3, 1, 2), want)


@pytest.mark.cuda
@pytest.mark.parametrize("op,kwargs", [
    ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", dict(kernel_size=2, ceil_mode=True)),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", dict(kernel_size=3, stride=1, padding="SAME")),
    ("adaptive_avg_pool2d", dict(output_size=1))])
def test_pool_nhwc_matches_nchw(cuda, op, kwargs):
    fn = getattr(P.nn.functional, op)
    x = torch.randn(4, 8, 15, 15, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    want = fn(x, **kwargs)
    got = fn(_nhwc(x), data_format="NHWC", **kwargs)
    _close(got.permute(0, 3, 1, 2), want)


class _Graphed:
    """A step function captured once in a CUDA graph (after a warm run on a
    side stream) and replayed."""

    def __init__(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            fn()

    def __call__(self):
        self.graph.replay()


@pytest.mark.cuda
def test_batch_norm_running_statistics_replay_equals_bodies(cuda):
    """N replays of a captured training forward write the running
    statistics into the same buffers, bit-equal to N bodies."""
    def make():
        P.seed(3)
        return P.nn.BatchNorm2D(32, data_format="NHWC")

    x = torch.randn(8, 9, 9, 32, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    body = make()
    for _ in range(5):
        body(x)
    graphed = make()
    mean = graphed._buffers["_mean"]
    run = _Graphed(lambda: graphed(x))      # the warm run is step 1
    for _ in range(4):
        run()
    torch.cuda.synchronize()
    assert graphed._buffers["_mean"] is mean
    for k in ("_mean", "_variance"):
        assert torch.equal(graphed._buffers[k], body._buffers[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_train_step_replays_equal_bodies(cuda, fmt):
    """Four Momentum steps of ResNet-18 (B 8, 64 x 64, O2 bf16) as bodies
    and through the captured step (a capture and three replays) from one
    saved state: losses, parameters, velocities and batch-norm statistics
    bit-equal."""
    P.seed(4)
    model = P.vision.models.resnet18(num_classes=100, data_format=fmt)
    P.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = P.optimizer.Momentum(0.1, 0.9, parameters=model.parameters(),
                               multi_precision=True)
    loss_fn = P.nn.CrossEntropyLoss()
    step = TrainStep(model, lambda o, y: loss_fn(o, y), opt)
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (8, 3, 64, 64) if fmt == "NCHW" else (8, 64, 64, 3)
    x = P.Tensor(torch.randn(shape, device="cuda", generator=g).bfloat16())
    y = P.Tensor(torch.randint(0, 100, (8,), device="cuda", generator=g))

    def state():    # detached: a live clone's graph would hold the
        # parameters' AccumulateGrad nodes (default stream) into the capture
        out = {k: v._value.detach().clone()
               for k, v in model.state_dict().items()}
        for name, store in opt._accumulators.items():
            out.update({f"{name}:{i}": t.detach().clone()
                        for i, t in enumerate(store.values())})
        return out

    start = step.export_state()
    with step._eager():
        body_losses = [step(x, y) for _ in range(4)]
    body = state()
    step.import_state(start)
    losses = [step(x, y) for _ in range(4)]
    assert len(step._programs) == 1
    (prog,) = step._programs.values()
    assert prog.capture is not None
    graph = state()
    assert torch.equal(torch.stack(losses), torch.stack(body_losses))
    assert all(np.isfinite(float(v)) for v in losses)
    assert body.keys() == graph.keys()
    for k in body:
        assert torch.equal(body[k], graph[k]), k
    assert model.bn1._mean.dtype == torch.float32
    assert model.conv1.weight.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(__import__("nn_fillin_cases").CASES))
def test_nn_fillin_case_on_the_card_matches_the_cpu(cuda, name):
    import nn_fillin_cases as C

    def capture(fn, ins, eager):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*ins)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = C._leaves(fn(*ins))
        graph.replay()
        torch.cuda.synchronize()
        return all(torch.equal(a._value, b._value)
                   for a, b in zip(out, eager))

    res = C.run_cases(P, "gpu:0", capture_case=capture, names=[name])
    in_f32 = C.CASES[name][3]
    for dtype in ("float64", "float32"):
        assert res[dtype][name] <= C.TOL["float32" if in_f32 else dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["flash", "flashmask"])
@pytest.mark.parametrize("kb,causal", [(2, True), (2, False), (1, True)])
def test_cross_length_attention_takes_the_plain_route(cuda, form, kb,
                                                      causal):
    """q [2, 128, 4, 64] against k [kb, 192, 4, 64] in bf16: "plain",
    bit-equal to ``_sdpa_core`` on the same tensors; and so is a head dim
    of 32 on self-attention shapes."""
    import importlib

    F = P.nn.functional
    fam = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(2, 128, 4, 64, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(kb, 192, 4, 64, device="cuda",
                        generator=g).bfloat16() for _ in range(2))
    sri = torch.sort(torch.randint(0, 129, (kb, 1, 192, 1 if causal else 2),
                                   device="cuda", generator=g),
                     -1).values.int()
    if form == "flash":
        out = F.flash_attention(q, k, v, causal=causal)[0]
        want = fam._sdpa_core(q, k, v, None, 0.125, causal, 0.0, False)
    else:
        out = F.flashmask_attention(q, k, v, sri, causal=causal)
        want = fam._sdpa_core(q, k, v, P.ops.flash_attention
                              .flashmask_allowed(128, sri, causal), 0.125,
                              False, 0.0, False)
    assert F.get_last_attention_backend() == "plain"
    assert torch.equal(out, want)
    # a head dim no kernel takes (32) on self-attention shapes: the plain
    # route too, as JAX computes it
    x = q[..., :32].contiguous()
    before = P.ops.flash_attention.flash_fwd.launches
    out = F.flash_attention(x, x, x, causal=True)[0]
    assert F.get_last_attention_backend() == "plain"
    assert P.ops.flash_attention.flash_fwd.launches == before
    assert torch.equal(out, fam._sdpa_core(x, x, x, None, 32 ** -0.5, True,
                                           0.0, False))


@pytest.mark.cuda
def test_lstm_lm_train_step_replays_equal_bodies(cuda):
    """Four SGD steps (global-norm clip) of a 2-layer LSTM language model
    with dropout as bodies and through the captured step from one saved
    state and generator seed: losses and parameters bit-equal."""
    from paddle_tpu_torch.framework import default_generator

    class LM(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = P.nn.Embedding(500, 64)
            self.lstm = P.nn.LSTM(64, 64, num_layers=2, dropout=0.3)
            self.head = P.nn.Linear(64, 500)

        def forward(self, ids, labels):
            logits = self.head(self.lstm(self.embed(ids))[0])
            return logits, P.nn.functional.cross_entropy(
                logits.reshape([-1, 500]), labels.reshape([-1]))

    P.seed(8)
    model = LM()
    opt = P.optimizer.SGD(1.0, parameters=model.parameters(),
                          grad_clip=P.nn.ClipGradByGlobalNorm(5.0))
    step = TrainStep(model, lambda logits, loss: loss, opt)
    toks = np.random.default_rng(1).integers(0, 500, (4, 13))
    ids, labels = P.to_tensor(toks[:, :-1]), P.to_tensor(toks[:, 1:])
    gen = default_generator("cuda")
    start = step.export_state()
    gen.manual_seed(3)
    with step._eager():
        body = torch.stack([step(ids, labels) for _ in range(4)])
    body_params = [p.detach().clone()
                   for p in torch.nn.Module.parameters(model)]
    step.import_state(start)
    gen.manual_seed(3)
    replay = torch.stack([step(ids, labels) for _ in range(4)])
    (prog,) = step._programs.values()
    assert prog.capture is not None
    assert torch.equal(replay, body)
    assert float(replay[-1]) < float(replay[0])
    for a, b in zip(torch.nn.Module.parameters(model), body_params):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gpt350m_width_block_under_o2_auto_cast_runs_the_flash_kernels(
        cuda):
    """Two GPT-350M-width blocks (hidden 1024, 16 heads of 64, SwiGLU
    4096; B 2, S 512), ``decorate(O2)`` + ``auto_cast(O2)``: logits bf16,
    loss f32, every gradient in its parameter's dtype, and one launch of
    each flash kernel per block in the forward and backward."""
    import paddle_tpu_torch.ops.flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=2,
                    num_heads=16, max_position=512)
    model = GPTForCausalLM(cfg, device="cuda", seed=2)
    P.amp.decorate(model, level="O2", dtype="bfloat16")
    ids = torch.randint(0, 50304, (2, 512), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    for w in fa._WRAPPERS.values():
        w.launches = 0
    with P.amp.auto_cast(level="O2", dtype="bfloat16"):
        logits, loss = model(ids, labels=torch.roll(ids, -1, 1))
    loss.backward()
    torch.cuda.synchronize()
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert np.isfinite(float(loss))
    for p in model.parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype
    assert [fa._WRAPPERS[k].launches for k in ("fwd", "dq", "dkv")] == \
        [2, 2, 2]
