#!/usr/bin/env python3
"""Time two checkouts' GPT training steps against each other on one card.

    python3 tools/train_step_ab.py OTHER_ROOT [--json PATH]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a git-ignored directory. The
training phase of ``chip_smoke.py`` (GPT-350M, O2 bf16, AdamW lr 1e-4,
weight decay 0.01, B 8, S 1024, one seeded batch) runs in four turns, in
the order other, this, this, other, each in a process of its own that
imports ``paddle_tpu_torch`` from one checkout. Each turn builds the model
from the same seed and times 2 warm-up + 8 timed calls of that checkout's
``TrainStep`` (host clock between two synchronisations); where the
checkout's TrainStep can run its steps as bodies without capture
(``_eager()``), it also times those, from a freshly built model. Prints the
card, each turn's times, each form's mean time per side, and whether the
forms' ten losses are equal bit for bit across sides and turns (the A/B
command line is ``tools/torch_kernel_ab.py``'s ``drive``). Needs one CUDA
card.
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_kernel_ab import drive  # noqa: E402


def turn(package_root, warmup=2, timed=8, B=8, S=1024, seed=12):
    """{"<form> ms": step ms, "<form> losses": [...]} of
    ``package_root``'s TrainStep, the forms "step" (its calls) and "body"
    where it has ``_eager``."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(package_root))  # ahead of ROOT
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m

    if not torch.cuda.is_available():
        raise SystemExit("train_step_ab: no CUDA device")
    cfg = gpt_350m()
    ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    ids = torch.as_tensor(ids_np, device="cuda")
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device="cuda")

    def build():
        model = GPTForCausalLM(cfg, device="cuda", seed=seed)
        amp.decorate(model, level="O2", dtype="bfloat16")
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        return TrainStep(model, lambda logits, loss: loss, opt)

    out = {"package": os.path.dirname(paddle_tpu_torch.__file__)}
    forms = [("step", contextlib.nullcontext)]
    if hasattr(TrainStep, "_eager"):
        forms.insert(0, ("body", lambda: step._eager()))
    for form, ctx in forms:
        step = build()
        with ctx():
            losses, step_s = chip_smoke.timed_steps(
                torch, step, (ids,), {"labels": labels}, warmup, timed)
        out[f"{form} ms"] = step_s * 1e3
        out[f"{form} losses"] = [float(x.float()) for x in losses]
        del step
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    drive(turn, __file__, __doc__.splitlines()[0])
