"""Packed-document training through ``jit.TrainStep`` on the CPU: the step
CUDA captures (``TrainStep``'s CPU body, on its static buffers) over a
stack of packed-attention blocks (RMSNorm -> ColumnParallelLinear ->
``F.flash_attn_varlen_qkvpacked`` -> RowParallelLinear -> residual), with
``cu_seqlens`` a batch tensor of the step.

* One ``cu_seqlens`` object serves q and k, so ``_same_cu`` takes its
  ``is`` branch: no value comparison (a host sync a capture would refuse)
  runs inside the step, even as the documents' order changes per step.
* Three steps equal three eager steps (forward, backward,
  ``Optimizer.step``) of a copy of the model: losses within 1e-5
  relative and parameters within 1e-5 (AdamW's bias correction is an f32
  pow of a device counter in the step and a float64 one eagerly; at lr
  1e-2 that moved the third loss by 1.3e-6 relative), every parameter
  updated in its own dtype.
"""
import copy
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from paddle_tpu_torch.framework import make_generator
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF

# the module (the package's ``flash_attention`` name is the function)
fa_mod = importlib.import_module(
    "paddle_tpu_torch.nn.functional.flash_attention")
DOCS = [9, 4, 7, 12]
HIDDEN, HEADS = 32, 2


class _Packed(torch.nn.Module):
    """Two packed-attention blocks; forward(x, cu, target) -> (out,
    target), so TrainStep hands the whole batch to the model."""

    def __init__(self):
        super().__init__()
        gen = make_generator(5, "cpu")
        self.blocks = torch.nn.ModuleList()
        for _ in range(2):
            # no biases, as GPT's linears: a K bias has an exactly zero
            # gradient, whose rounding noise AdamW scales to whole steps
            blk = torch.nn.ModuleDict(dict(
                norm=RMSNorm(HIDDEN),
                qkv=ColumnParallelLinear(HIDDEN, 3 * HIDDEN, has_bias=False),
                proj=RowParallelLinear(HIDDEN, HIDDEN, has_bias=False)))
            blk.qkv.reset_parameters(gen)
            blk.proj.reset_parameters(gen)
            self.blocks.append(blk)

    def forward(self, x, cu, target):
        T = x.shape[0]
        for blk in self.blocks:
            qkv = blk.qkv(blk.norm(x)).reshape(T, 3, HEADS, HIDDEN // HEADS)
            out, _ = TF.flash_attn_varlen_qkvpacked(qkv, cu, cu, 16, 16,
                                                    causal=True)
            x = x + blk.proj(out.reshape(T, HIDDEN))
        return x, target


def _mse(out, target):
    return ((out - target) ** 2).mean()


def _batches(n=3):
    rng = np.random.default_rng(0)
    T = sum(DOCS)
    x = torch.from_numpy(rng.standard_normal((T, HIDDEN)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((T, HIDDEN)).astype(np.float32))
    out = []
    for _ in range(n):
        lens = rng.permutation(DOCS)
        out.append((x, torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lens)])), y))
    return out


def test_packed_train_step_equals_eager_steps(monkeypatch):
    model = _Packed()
    eager = copy.deepcopy(model)
    step = TrainStep(model, _mse, topt.AdamW(learning_rate=1e-2,
                                             parameters=model.parameters()))
    opt = topt.AdamW(learning_rate=1e-2, parameters=eager.parameters())
    calls = []
    real = fa_mod._same_cu

    def spy(a, b):
        calls.append(a is b)
        return real(a, b)

    def no_value_comparison(*a, **k):
        raise AssertionError("the boundaries were compared by value")

    monkeypatch.setattr(fa_mod, "_same_cu", spy)
    losses, eager_losses = [], []
    for x, cu, y in _batches():
        with monkeypatch.context() as m:
            m.setattr(torch, "equal", no_value_comparison)
            losses.append(float(step(x, cu, y)))
        loss = _mse(*eager(x, cu, y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager_losses.append(float(loss.detach()))
    assert calls and all(calls)
    assert len(step._programs) == 1             # one key for every order
    np.testing.assert_allclose(losses, eager_losses, rtol=1e-5)
    for (k, a), b in zip(model.named_parameters(), eager.parameters()):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert losses[-1] < losses[0]


def test_two_boundary_objects_compare_values_outside_a_step():
    """The value comparison stays for two objects (eager callers): it
    agrees on equal boundaries and refuses the kernel route on unequal
    ones, as JAX's ``_same_cu`` does."""
    cu = torch.tensor([0, 9, 13, 20, 32])
    assert fa_mod._same_cu(cu, cu.clone())
    assert not fa_mod._same_cu(cu, torch.tensor([0, 8, 13, 20, 32]))
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.flash_attn_unpadded(torch.ones(32, 2, 16), torch.ones(32, 2, 16),
                               torch.ones(32, 2, 16), cu, cu, 12, 12, 0.25,
                               dropout=0.5)
