"""The nn surface on the card: channels-last convolutions and pools held to
channels-first ones, batch-norm running statistics through a captured
step equal to bodies, and ResNet-18 trained through the captured
``TrainStep`` bit-equal to its bodies. Every test here is marked ``cuda``
and skips without a GPU. This file imports torch and the port only (no
JAX):

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
