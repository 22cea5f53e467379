"""Seeded violation: one buffer dwarfs the budget — the accidental giant
broadcast (a mask or position grid materialized dense instead of staying
tiled), in torch.

``make_program`` is the hbm fixture contract (``paddle_tpu_torch/analysis/
hbm.py`` ``hbm_fixture_reports``): the traced function expands a 16 KiB
vector into a dense 16 MiB [1024, 4096] f32 buffer (``contiguous`` makes
it real) before reducing it away, so the liveness walk sees a single
16 MiB storage at the peak — over 25% of the declared 32 MiB budget. The
program-only plan has no pool or params and no measured peak, so strict
fixture mode reports exactly one HIGH: oversized-temp.
"""
import torch

BUDGET_BYTES = 32 << 20


def make_program():
    def fn(x):
        dense = x[None, :].expand(1024, 4096).contiguous()
        return dense.sum()

    return fn, (torch.zeros(4096),)
