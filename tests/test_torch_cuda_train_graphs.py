"""The captured training step, on the card. Every test here is marked
``cuda`` and skips without a GPU.

This file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_train_graphs.py

A small GPT with the kernels' head dim (2 layers, 2 heads of 64, vocab
256, B 2, S 128) trains through ``TrainStep`` twice from the same seed:
once with every step run as its body without capture (``_eager()``, the
reference), once captured and replayed. The same kernels run in the same
order on the same inputs, so losses and parameters must be bit-equal
(f32 and O2 bf16, under each ``capture_error_mode``); so must a scheduled
rate read per replay, ``run_steps`` against calls, and a step replayed
after ``import_state``, which must capture nothing new. A host sync in
the loss must make the capture raise and leave the state as it was, and
the flash launch counts must go on counting through replays.

The slice's training options, captured: dropout (each replay draws new
masks from the port's generator, registered with the graph; a replay
equals a body from the same generator state; ``import_state`` brings the
masks back), recompute ("block" and "dots" equal to no recompute, with
and without dropout), AMP O1 (the casts of the key's first call), the
other optimizers (replays equal bodies), and packed documents with
``cu_seqlens`` as a batch tensor (a second boundaries object makes the
capture raise: comparing them is a host sync).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.framework import default_generator
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import train as jit_train
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import ClipGradByNorm
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import lr

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position=256)
B, S = 2, 128


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _batch(seed=0, n=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (n, B, S) if n else (B, S))
    return (torch.as_tensor(ids, device="cuda"),
            torch.as_tensor(np.roll(ids, -1, axis=-1), device="cuda"))


def _step(dtype="float32", make_opt=None, seed=3, **config):
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG, **config),
                                device="cuda", seed=seed)
    opt = (make_opt or (lambda params: optimizer.AdamW(
        learning_rate=1e-3, parameters=params, weight_decay=0.01,
        multi_precision=True)))(model.parameters())
    if dtype == "bfloat16":
        amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, TrainStep(model, lambda logits, loss: loss, opt)


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _captures(step):
    return [p.capture for p in step._programs.values()
            if p.capture is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replays_equal_the_bodies(cuda, dtype):
    ids, labels = _batch()
    ref_m, ref = _step(dtype)
    m, step = _step(dtype)
    with ref._eager():
        want = [ref(ids, labels=labels) for _ in range(5)]
    got = [step(ids, labels=labels) for _ in range(5)]
    assert len(_captures(step)) == 1 and not _captures(ref)
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert _equal(_params(m), _params(ref_m))
    assert got[-1] < got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["global", "thread_local", "relaxed"])
def test_each_capture_mode_captures_the_whole_step(cuda, mode, monkeypatch):
    """backward() launches from autograd's device thread; the step is
    captured whole (the same losses and parameters as the bodies) under
    every ``capture_error_mode``. TrainStep uses "global"."""
    monkeypatch.setattr(jit_train, "_CAPTURE_MODE", mode)
    ids, labels = _batch(1)
    ref_m, ref = _step("bfloat16")
    m, step = _step("bfloat16")
    with ref._eager():
        want = [ref(ids, labels=labels) for _ in range(3)]
    got = [step(ids, labels=labels) for _ in range(3)]
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert _equal(_params(m), _params(ref_m))


@pytest.mark.cuda
def test_each_replay_reads_its_own_learning_rate(cuda):
    def make(params):
        sched = lr.LinearWarmup(
            learning_rate=lr.CosineAnnealingDecay(learning_rate=0.05,
                                                  T_max=4),
            warmup_steps=2, start_lr=0.005, end_lr=0.05)
        return optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                  parameters=params,
                                  grad_clip=ClipGradByNorm(1.0))

    ids, labels = _batch(2)
    ref_m, ref = _step("bfloat16", make)
    m, step = _step("bfloat16", make)
    rates = []
    for i in range(5):
        rates.append(step.optimizer.get_lr())
        with ref._eager():
            want = ref(ids, labels=labels)
        assert torch.equal(step(ids, labels=labels), want), i
        assert _equal(_params(m), _params(ref_m)), i
        for s in (ref, step):
            s.optimizer._learning_rate.step()
    assert len(set(rates)) == 5 and len(_captures(step)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_run_steps_equals_replayed_calls(cuda, stacked):
    K = 4
    ids, labels = _batch(3, n=K + 1) if stacked else _batch(3)

    def batch(i):
        return (ids[i], labels[i]) if stacked else (ids, labels)

    m_a, a = _step("bfloat16")
    m_b, b = _step("bfloat16")
    seq = [a(*batch(i)) for i in range(K + 1)]  # body + capture, replays
    assert torch.equal(b(*batch(0)), seq[0])
    if stacked:
        got = b.run_steps(K, ids[1:], labels[1:], stacked=True)
    else:
        got = b.run_steps(K, ids, labels)
    assert torch.equal(got, torch.stack(seq[1:]))
    assert _equal(_params(m_a), _params(m_b))
    assert len(_captures(b)) == 1


@pytest.mark.cuda
def test_import_state_then_replay_equals_the_uninterrupted_run(cuda):
    ids, labels = _batch(4)
    m, step = _step("bfloat16")
    step(ids, labels=labels)                    # body, then capture
    step(ids, labels=labels)
    snap = step.export_state()
    cap = _captures(step)
    after = step(ids, labels=labels)
    after_params = _params(m)
    step(ids, labels=labels)
    step.import_state(snap)
    assert step.optimizer._step_count == 2
    assert torch.equal(step(ids, labels=labels), after)
    assert _equal(_params(m), after_params)
    assert _captures(step) == cap and len(cap) == 1


@pytest.mark.cuda
def test_aot_prime_captures_ahead_and_mutates_nothing(cuda):
    ids, labels = _batch(5)
    m, step = _step("bfloat16")
    m_ref, ref = _step("bfloat16")
    before = _params(m)
    prog = step.aot_prime(ids, labels=labels)
    assert prog.capture is not None and prog.flops > 0
    assert _equal(_params(m), before) and step.optimizer._step_count == 0
    assert all(torch.count_nonzero(v) == 0 for store in
               step.optimizer._accumulators.values() for v in store.values())
    with ref._eager():
        want = ref(ids, labels=labels)
    assert torch.equal(step(ids, labels=labels), want)      # a replay
    assert _captures(step) == [prog.capture]
    assert _equal(_params(m), _params(m_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["item", "cpu"])
def test_a_host_sync_in_the_loss_makes_the_capture_raise(cuda, sync):
    def loss_fn(logits, loss):
        if sync == "item":
            return loss + 0 * float(loss)
        return loss + torch.as_tensor(loss.detach().cpu(), device="cuda") * 0

    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cuda", seed=3)
    step = TrainStep(model, loss_fn, optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    ids, labels = _batch(6)
    before = _params(model)
    with pytest.raises(RuntimeError):
        step(ids, labels=labels)            # the body runs; its capture fails
    assert not _captures(step)
    with pytest.raises(RuntimeError):
        step(ids, labels=labels)            # and no quiet fallback either
    torch.cuda.synchronize()
    assert float(torch.ones(3, device="cuda").sum()) == 3.0
    # each failed call is undone: the body's update does not stand
    assert _equal(_params(model), before)
    assert step.optimizer._step_count == 0 and step._seed == 0


@pytest.mark.cuda
def test_flash_launch_counts_go_on_through_replays(cuda):
    ids, labels = _batch(7)
    _, step = _step("bfloat16")
    L = CFG["num_layers"]
    before = {k: w.launches for k, w in fa._WRAPPERS.items()}
    for _ in range(4):                      # body + capture, three replays
        step(ids, labels=labels)
    grew = {k: w.launches - before[k] for k, w in fa._WRAPPERS.items()}
    assert grew == {"fwd": 4 * L, "dq": 4 * L, "dkv": 4 * L,
                    "fm_fwd": 0, "fm_dq": 0, "fm_dkv": 0}


def _sgd(rate):
    return lambda params: optimizer.SGD(learning_rate=rate,
                                        parameters=params)


@pytest.mark.cuda
def test_dropout_replays_draw_new_masks_and_import_state_repeats_them(cuda):
    """lr 0 keeps the parameters, so losses differ only by their masks."""
    ids, labels = _batch(8)
    gen = default_generator(cuda)
    m, step = _step(make_opt=_sgd(0.0), dropout=0.1)
    ref_m, ref = _step(make_opt=_sgd(0.0), dropout=0.1)
    first = step(ids, labels=labels)                # body, then capture
    snap = step.export_state()
    state = gen.get_state()
    a = step(ids, labels=labels)                    # replays
    b = step(ids, labels=labels)
    assert len(_captures(step)) == 1
    assert not torch.equal(a, b) and not torch.equal(a, first)
    step.import_state(snap)
    assert torch.equal(step(ids, labels=labels), a)
    gen.set_state(state)
    with ref._eager():
        assert torch.equal(ref(ids, labels=labels), a)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("policy", ["block", "dots"])
def test_captured_recompute_equals_no_recompute(cuda, policy, dropout):
    ids, labels = _batch(9)
    gen = default_generator(cuda)
    runs = {}
    for name, remat in (("plain", None), ("recompute", policy)):
        m, step = _step("bfloat16", make_opt=_sgd(0.5), dropout=dropout,
                        recompute=remat)
        gen.manual_seed(17)
        runs[name] = ([step(ids, labels=labels) for _ in range(3)],
                      _params(m))
        assert len(_captures(step)) == 1
    assert torch.equal(torch.stack(runs["plain"][0]),
                       torch.stack(runs["recompute"][0]))
    assert _equal(runs["plain"][1], runs["recompute"][1])


@pytest.mark.cuda
def test_an_o1_step_keeps_the_casts_of_its_first_call(cuda):
    ids, labels = _batch(10)
    ref_m, ref = _step(make_opt=_sgd(0.5))
    m, step = _step(make_opt=_sgd(0.5))
    with amp.auto_cast(dtype="bfloat16"):
        with ref._eager():
            want = [ref(ids, labels=labels) for _ in range(3)]
        got = [step(ids, labels=labels)]
    got += [step(ids, labels=labels) for _ in range(2)]     # outside it
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert _equal(_params(m), _params(ref_m))
    assert len(_captures(step)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Adamax", "Adagrad", "Adadelta", "RMSProp",
                                  "Lamb", "ASGD", "Rprop", "NAdam", "RAdam"])
def test_the_other_optimizers_replay_their_bodies(cuda, name):
    def make(params):
        return getattr(optimizer, name)(learning_rate=1e-2,
                                        parameters=params)

    ids, labels = _batch(11)
    ref_m, ref = _step(make_opt=make)
    m, step = _step(make_opt=make)
    with ref._eager():
        want = [ref(ids, labels=labels) for _ in range(3)]
    got = [step(ids, labels=labels) for _ in range(3)]
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert _equal(_params(m), _params(ref_m))


class _Packed(torch.nn.Module):
    """Two packed-attention blocks over [T, 128] tokens (2 heads of 64);
    ``clone_k`` hands k its own copy of the boundaries."""

    def __init__(self, clone_k=False):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            ColumnParallelLinear,
            RowParallelLinear,
        )
        from paddle_tpu_torch.framework import make_generator

        gen = make_generator(5, "cuda")
        self.clone_k = clone_k
        self.qkv = torch.nn.ModuleList(
            ColumnParallelLinear(128, 384, has_bias=False, device="cuda")
            for _ in range(2))
        self.proj = torch.nn.ModuleList(
            RowParallelLinear(128, 128, has_bias=False, device="cuda")
            for _ in range(2))
        for lin in (*self.qkv, *self.proj):
            lin.reset_parameters(gen)

    def forward(self, x, cu, target):
        from paddle_tpu_torch.nn import functional as F

        T = x.shape[0]
        for qkv, proj in zip(self.qkv, self.proj):
            q, k, v = qkv(x).reshape(T, 3, 2, 64).unbind(1)
            out, _ = F.flash_attn_unpadded(
                q, k, v, cu, cu.clone() if self.clone_k else cu, 512, 512,
                0.125, causal=True)
            x = x + proj(out.reshape(T, 128))
        return ((x - target) ** 2).mean()


def _packed_batch(seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    lens = rng.permutation([300, 200, 150, 100, 74])
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                         device="cuda")
    x = torch.as_tensor(rng.standard_normal((824, 128)), dtype=torch.float32,
                        device="cuda")
    return x.to(dtype), cu, x.roll(1, 0)


@pytest.mark.cuda
def test_packed_steps_capture_with_cu_seqlens_a_batch_tensor(cuda):
    def make():
        model = _Packed()
        amp.decorate(model, level="O2", dtype="bfloat16")
        return model, TrainStep(model, lambda loss: loss, optimizer.AdamW(
            learning_rate=1e-3, parameters=model.parameters()))

    ref_m, ref = make()
    m, step = make()
    batches = [_packed_batch(s) for s in range(4)]   # a new order each
    with ref._eager():
        want = [ref(*b) for b in batches]
    before = fa.flashmask_fwd.launches
    got = [step(*b) for b in batches]
    assert fa.flashmask_fwd.launches - before == 2 * 4
    assert len(_captures(step)) == 1 and len(step._programs) == 1
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert _equal(_params(m), _params(ref_m))
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}


@pytest.mark.cuda
def test_two_boundaries_objects_make_the_packed_capture_raise(cuda):
    model = _Packed(clone_k=True)
    step = TrainStep(model, lambda loss: loss, optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    before = _params(model)
    with pytest.raises(RuntimeError):
        step(*_packed_batch(0, torch.float32))  # the capture syncs
    assert not _captures(step) and _equal(_params(model), before)
    # the generator the capture registered draws again outside captures
    from paddle_tpu_torch.nn.functional.common import keep_mask
    assert keep_mask((64,), 0.5, "cuda").shape == (64,)


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [None, "block"])
def test_llama_at_full_width_captured_equals_its_bodies(cuda, recompute):
    """Two LLaMA-2-7B layers at full width (hidden 4096, 32 heads of 128,
    SwiGLU 11008, vocab 32000), O2 bf16, AdamW, B 1, S 512: three steps
    as bodies and the same three captured and replayed from one state give
    bit-equal losses and parameters, and the flash kernels launch per
    layer and step (the forward twice under recompute)."""
    from paddle_tpu_torch.models import llama as tllama

    cfg = tllama.llama2_7b()
    cfg.num_layers, cfg.recompute = 2, recompute
    model = tllama.LlamaForCausalLM(cfg, device=cuda, dtype=torch.bfloat16,
                                    seed=5)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda logits, loss: loss, opt)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 32000,
                                                            (1, 512)),
                          device=cuda)
    labels = ids.roll(-1, dims=1)
    start = step.export_state()
    with step._eager():
        body = [step(ids, labels=labels) for _ in range(3)]
    body_params = _params(model)
    step.import_state(start)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0
    replay = [step(ids, labels=labels) for _ in range(3)]
    assert torch.equal(torch.stack(replay), torch.stack(body))
    assert _equal(_params(model), body_params)
    assert float(replay[-1]) < float(replay[0])
    assert len(_captures(step)) == 1
    fwd = 2 if recompute else 1
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (fwd * 2 * 3, 2 * 3, 2 * 3)
