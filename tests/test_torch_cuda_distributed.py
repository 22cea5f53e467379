"""The distributed slice on the card: NCCL at one rank (one H100 holds no
second rank). Each test runs ranks in fresh processes through
``chip_smoke.distributed_phase`` pieces, so a process group never outlives
its test. Marked ``cuda``; skips without a GPU. Imports torch, numpy and
the port only.

* every collective of ``distributed.collective`` on CUDA tensors gives its
  one-rank answer;
* a tiny GPT's ``DataParallel`` TrainStep, captured with its NCCL
  all-reduce inside the graph (run at the capture, by no replay), gives
  the bare TrainStep's losses and parameters bit for bit;
* ``serving_mesh(dp=1, tp=1)`` gives the plain scheduler's greedy tokens
  (at one rank the mesh is a no-op: no lockstep runs);
* the paged and flash kernels on tp = 2 and 4 head shards agree with the
  plain version of the whole call.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def record():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL on the card)")
    import chip_smoke

    return chip_smoke.distributed_phase(world=1, device="cuda", tiny=True,
                                        timeout=600)


def test_collectives_on_the_card(record):
    assert record["backend"] == "nccl" and record["world"] == 1
    assert all(record["collectives"].values()), record["collectives"]


def test_data_parallel_train_step_captures_the_all_reduce(record):
    tr = record["train"]
    assert tr["bit_equal"] and tr["params_bit_equal"], tr
    assert tr["data_parallel"]["captures"] == 1
    # synced at the first run and at the capture, never by a replay
    assert tr["data_parallel"]["syncs"] == 2


def test_serving_mesh_tokens(record):
    assert record["serve"]["tokens_equal"]
    assert record["serve"]["paged_launches"] > 0
    assert not record["serve"]["lockstep"]


def test_kernels_on_head_shards(record):
    for key, r in record["shards"].items():
        assert r["ok"], (key, r)
    assert record["ulysses"]["ok"]
