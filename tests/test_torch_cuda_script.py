"""The training script's surface on the card: the flash forward's operator
(``torch.ops.paddle_tpu_torch.flash_fwd``) against its plain version; a
``jit.save`` export made on the CPU that launches the kernel when it is
loaded on the card, and one made on the card that runs the plain version
on the CPU; head dims no kernel takes (32, 96, 256) on the plain route;
``io.DataLoader`` workers that never initialise CUDA; ``Model.fit``
through the captured step and an in-place restore that captures nothing
new; ``jit.to_static`` captured once and replayed. Every test here is
marked ``cuda`` and skips without a GPU. This file imports torch, numpy
and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_script.py

Tolerances: kernel against plain, ``ops.flash_attention.kernel_tolerance``
(elementwise, from where the two round); whole f32 forwards through the
kernel against the CPU's plain version, 1e-4 of the largest |logit|
(f32 sums in another order, TF32 off); the plain route, bit for bit.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as pdev
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops import flash_attention as fa

# the package's name ``flash_attention`` is the function: the module
fam = importlib.import_module(
    "paddle_tpu_torch.nn.functional.flash_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    prev = pdev._current["place"]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    P.set_device("gpu:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    pdev._current["place"] = prev
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _gpt(device, seed=0):
    cfg = GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                    num_heads=2, max_position=64)
    return GPTForCausalLM(cfg, device=device, seed=seed)


def _ids(B=3, S=48, seed=0):
    return torch.randint(0, 128, (B, S),
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_operator_is_the_kernel_on_the_card(cuda, dtype, causal):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(2, 256, 4, 64, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    before = fa.flash_fwd.launches
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, causal, 0.125)
    assert fa.flash_fwd.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal, 0.125)
    lim = fa.kernel_tolerance(q, k, v, {"out": ref_out, "lse": ref_lse},
                              causal, 0.125)
    assert bool(((out.float() - ref_out.float()).abs() <= lim["out"]).all())
    assert bool(((lse - ref_lse).abs() <= lim["lse"]).all())


@pytest.mark.cuda
def test_export_made_on_the_cpu_launches_the_kernel_on_the_card(cuda,
                                                                tmp_path):
    net = _gpt("cpu").eval()
    ids = _ids()
    with torch.no_grad():
        want = net(ids)
    path = str(tmp_path / "cpu_export")
    P.jit.save(net, path, input_spec=[P.static.InputSpec([None, 48],
                                                         "int64")])
    layer = P.jit.load(path, device="cuda")
    before = fa.flash_fwd.launches
    got = layer(ids.cuda())._value
    assert fa.flash_fwd.launches - before == 2          # one per layer
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    got5 = layer(_ids(B=5, seed=1).cuda())._value       # another batch
    assert tuple(got5.shape) == (5, 48, 128)


@pytest.mark.cuda
def test_export_made_on_the_card_runs_the_plain_version_on_the_cpu(
        cuda, tmp_path):
    net = _gpt("cuda").eval()
    ids = _ids()
    with torch.no_grad():
        want = net(ids.cuda())
    path = str(tmp_path / "card_export")
    P.jit.save(net, path, input_spec=[P.static.InputSpec([None, 48],
                                                         "int64")])
    layer = P.jit.load(path, device="cpu")
    before = fa.flash_fwd.launches
    got = layer(ids)._value
    assert fa.flash_fwd.launches == before
    assert got.device.type == "cpu"
    assert float((got - want.cpu()).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 256])
def test_head_dims_no_kernel_takes_run_the_plain_route(cuda, d):
    F = P.nn.functional
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 128, 4, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    before = (fa.flash_fwd.launches, fa.flashmask_fwd.launches)
    out = F.flash_attention(q, k, v, causal=True)[0]
    assert F.get_last_attention_backend() == "plain"
    assert torch.equal(out, fam._sdpa_core(q, k, v, None, scale, True, 0.0,
                                           False))
    sri = torch.full((2, 1, 128, 1), 100, dtype=torch.int32, device="cuda")
    masked = F.flashmask_attention(q, k, v, sri, causal=True)
    assert F.get_last_attention_backend() == "plain"
    assert torch.equal(masked, fam._sdpa_core(
        q, k, v, fa.flashmask_allowed(128, sri, True), scale, False, 0.0,
        False))
    cu = torch.tensor([0, 100, 256], dtype=torch.int32, device="cuda")
    packed = q.reshape(256, 4, d)
    F.flash_attn_unpadded(packed, packed, packed, cu, cu, 156, 156, scale,
                          causal=True)
    assert F.get_last_attention_backend() == "plain"
    assert (fa.flash_fwd.launches, fa.flashmask_fwd.launches) == before
    from paddle_tpu_torch.models.steps import kernel_serves

    assert not kernel_serves("kernel", q)
    assert kernel_serves("kernel", torch.zeros(1, 1, 4, 64, device="cuda"))


@pytest.mark.cuda
def test_gpt_at_head_dim_32_decodes_on_the_plain_route(cuda):
    """A GPT whose head dim no decode kernel takes: dense ``generate`` on
    the card runs the plain versions (no launch) and gives the tokens of the
    same model on the CPU."""
    from paddle_tpu_torch.ops import decode_attention as da

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=2, max_position=64)
    net = GPTForCausalLM(cfg, device="cuda", seed=4).eval()
    cpu = GPTForCausalLM(cfg, device="cpu", seed=4).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    ids = _ids(B=2, S=8, seed=4)
    before = da.decode_attention.launches
    got = net.generate(ids.cuda(), max_new_tokens=4, dtype="float32")
    assert da.decode_attention.launches == before
    want = cpu.generate(ids, max_new_tokens=4, dtype="float32")
    assert torch.equal(torch.as_tensor(got).cpu(), torch.as_tensor(want))


class _Flags(P.io.Dataset):
    """Each sample says whether its worker had CUDA initialised."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.float32(i), np.int64(torch.cuda.is_initialized())


@pytest.mark.cuda
def test_dataloader_workers_never_initialise_cuda(cuda):
    torch.zeros(1, device="cuda")          # the main process has CUDA up
    batches = list(P.io.DataLoader(_Flags(), batch_size=4, num_workers=2))
    assert len(batches) == 2
    for x, flag in batches:
        assert x.place.is_gpu_place() and flag.place.is_gpu_place()
        assert int(flag._value.sum()) == 0
    np.testing.assert_array_equal(
        np.concatenate([x.numpy() for x, _ in batches]), np.arange(8))


@pytest.mark.cuda
def test_fit_replays_and_an_in_place_restore_captures_nothing(cuda,
                                                              tmp_path):
    from paddle_tpu_torch.framework.checkpoint import CheckpointManager

    net = _gpt("cuda", seed=2)
    opt = P.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())
    model = P.Model(net).prepare(
        opt, lambda logits, y: torch.nn.functional.cross_entropy(
            logits.reshape(-1, 128), y.reshape(-1)))
    ids = _ids(B=16, S=49, seed=2).numpy()
    data = [(ids[i, :-1], ids[i, 1:]) for i in range(16)]
    losses = []

    class Rec(P.hapi.callbacks.Callback):
        def on_batch_end(self, mode, step, logs=None):
            losses.append(logs["loss"][0])

    model.fit(data, batch_size=4, shuffle=False, verbose=0, callbacks=[Rec()],
              checkpoint_dir=str(tmp_path), checkpoint_every=2)
    step = model._train_step
    assert (step.captures, step.replays) == (1, 3)
    assert not model._train_step_broken
    assert CheckpointManager(str(tmp_path)).restore(step, step=2) == 2
    again = [model.train_batch(P.to_tensor(ids[i:i + 4, :-1]),
                               P.to_tensor(ids[i:i + 4, 1:]))[0]
             for i in (8, 12)]
    assert again == losses[2:]
    assert (step.captures, step.replays) == (1, 5)


@pytest.mark.cuda
def test_to_static_captures_once_and_replays(cuda):
    net = _gpt("cuda", seed=5).eval()
    fn = P.jit.to_static(net)
    ids = _ids(seed=5).cuda()
    with torch.no_grad():
        want = net(ids)
        first = fn(ids)
        second = fn(ids)
    assert (fn.captures, fn.replays) == (1, 1)
    assert torch.equal(first, want) and torch.equal(second, want)


class _Ramp(P.nn.Layer):
    def forward(self, x):
        return x * 2.0 + 1.0


@pytest.mark.cuda
def test_parameter_free_layer_builds_on_the_card(cuda, tmp_path):
    """With the card as the place, a parameter-free layer's program and
    example inputs are built there (they were built on the CPU)."""
    fn = P.jit.to_static(_Ramp())
    assert fn._device([]).type == "cuda"
    path = str(tmp_path / "ramp")
    P.jit.save(_Ramp(), path,
               input_spec=[P.static.InputSpec([None, 4], "float32")])
    loaded = P.jit.load(path)
    x = torch.arange(8, dtype=torch.float32, device="cuda").reshape(2, 4)
    out = loaded(P.to_tensor(x))
    out = out._value if hasattr(out, "_value") else out
    assert out.device.type == "cuda"
    assert torch.equal(out, x * 2.0 + 1.0)
