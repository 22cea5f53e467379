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
  plain version of the whole call;
* the MoE layer over the one-rank expert group, the converted
  SyncBatchNorm net under DataParallel and rpc over the launcher's store.
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


# ------------------------------------------------------ the pipeline slice
def test_zero_stages_captured_bit_equal_to_bare(record):
    """ZeRO 1-3 under the captured TrainStep at one NCCL rank: the stages'
    reduce-scatters and all-gathers inside the graph, the parameters after
    the steps bit-equal to the bare TrainStep's."""
    zero = record["pipeline"]["zero"]
    for k in ("zero1", "zero2", "zero3"):
        r = zero["stages"][k]
        assert r["ok"] and r["params_bit_equal"], (k, r)
        assert r["captures"] == 1 and r["sliced"] > 0, (k, r)


def test_checkpoint_round_trip_of_card_tensors(record):
    ck = record["pipeline"]["zero"]["checkpoint"]
    assert ck["params_bit_equal"] and ck["opt_bit_equal"], ck
    assert ck["next_params_bit_equal"] and ck["bytes"] > 0, ck


def test_two_stage_gpt350m_pipeline_against_the_unpipelined_step():
    """GPT-350M at full width, 4 layers, as a 2-stage pipeline at world
    size 1 (every stage in this process, no process group): its 1F1B
    losses and parameters against the unpipelined micro-batch
    accumulation of the same model and batches (f32: losses within
    1e-5 relative; the whole model's gap within 1e-3), and each flash
    kernel's launches as the streams predict."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import chip_smoke
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet import pipeline as pl
    from paddle_tpu_torch.framework import default_generator
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_pipeline
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    _build.build_all()
    cfg = GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=4,
                    num_heads=16)
    m = 4
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 512)),
                          device="cuda")
    labels = torch.roll(ids, -1, 1)
    gen = default_generator("cuda")

    def opt_of(model):
        return optimizer.AdamW(learning_rate=1e-4,
                               parameters=model.parameters())

    ref = gpt_pipeline(cfg, num_stages=1, device="cuda", seed=5)
    init = {k: getattr(t, "_value", t).detach().clone()
            for k, t in ref.state_dict().items()}
    opt = opt_of(ref)
    ref_losses = []
    for _ in range(3):
        s = pl.micro_seed(gen)
        after = gen.get_state()
        total = 0
        for i, (x, y) in enumerate(zip(ids.chunk(m), labels.chunk(m))):
            gen.manual_seed(s + i)
            loss = ref.loss_fn(ref(x), y)
            (loss / m).backward()
            total = total + loss.detach()
        gen.set_state(after)
        opt.step()
        opt.clear_grad()
        ref_losses.append(float(total / m))
    want = {k: getattr(t, "_value", t).detach().clone()
            for k, t in ref.state_dict().items()}
    del ref, opt

    model = gpt_pipeline(cfg, num_stages=2, device="cuda", seed=5)

    class S:
        pipeline_configs = {"accumulate_steps": m, "schedule_mode": "1F1B"}
        hybrid_configs = {}

    wrapper = pl.PipelineParallel(model, strategy=S())
    opt = opt_of(model)
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    losses = [float(wrapper.train_batch((ids, labels), opt))
              for _ in range(3)]
    got = chip_smoke.flash_launches(fa)
    predicted = chip_smoke.pipe_predicted_launches(
        model, 2, 1, m, "1F1B", wrapper._engine.mine)
    assert got == {k: 3 * v for k, v in predicted.items()}, (got, predicted)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    have = {k: getattr(t, "_value", t) for k, t in model.state_dict().items()}
    gap = chip_smoke._pipe_model_gap(torch, have, want, init)
    assert gap <= 1e-3, gap


def test_moe_ep_sync_bn_and_rpc_on_the_card(record):
    """The worker's last legs at a tiny size: the MoE layer over the
    one-rank group (NCCL's all-to-all carrying dispatch and return) is
    the layer without a group bit for bit, forward, l_aux and gradients;
    the converted SyncBatchNorm net under DataParallel, captured, is the
    bare BatchNorm net's step bit for bit; rpc round trips over the
    launcher's native store."""
    moe, bn, rpc = record["moe_ep"], record["sync_bn"], record["rpc"]
    assert moe["ok"] and moe["out_bit_equal"] and moe["grads_bit_equal"]
    assert moe["l_aux_bit_equal"] and moe["a2a_launches"] == 4
    assert bn["ok"] and bn["losses_bit_equal"] and bn["state_bit_equal"]
    assert bn["sync"]["captures"] == 1 and bn["bare"]["captures"] == 1
    assert rpc["ok"] and rpc["server"] == "native"
