"""Pipeline parallelism of the port against the JAX package's
(``tests/test_pipeline_parallel.py``'s models): the schedules' streams,
``SegmentLayers``' cuts, a Linear stack at pp 4, at pp 2 x dp 2 and at
VPP 2 (4 gloo ranks, each holding its stage) against JAX's
``PipelineParallel`` and its single-device micro-batch accumulation over
10 steps, shared (tied) layers across stages, the world-1 in-process
engine, and ``gpt_pipeline`` on a 4-layer ``gpt_tiny`` at pp 2, tied (pp
2 x dp 2) and untied (pp 2 x mp 2), with AdamW and a global-norm clip.

The same initial weights go to both packages (JAX's state, cut for each
rank by ``bridge.stage_state``); each rank's batch is its (dp, sharding)
block of each micro-batch. f32 throughout: losses within rtol 1e-5, atol
1e-6 (JAX's own bound, ``tests/test_hybrid_parallel.py:113``), parameters
within atol 1e-6 after SGD, and after AdamW each leaf's ``param_gap``
(the summed difference over the summed movement) within 1e-3.
"""
import numpy as np
import pytest
import torch

import dist_ranks
import paddle_tpu as paddle
from port_bodies import on_cpu  # noqa: F401 (a fixture)
from paddle_tpu import nn
from paddle_tpu.distributed.fleet import pipeline as jpipe
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc,
    PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel,
    PipelineParallelWithInterleave as JInterleave,
    SegmentLayers as JSegmentLayers,
    SharedLayerDesc as JSharedLayerDesc,
)
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_pipeline as jgpt_pipeline

from paddle_tpu_torch.bridge import gather_parts
from paddle_tpu_torch.distributed.fleet import pipeline as tpipe

HID, N_LAYERS, MICRO, BATCH = 16, 8, 4, 8
CLIP = 0.5
GPT = dict(vocab_size=1024, hidden_size=64, num_layers=4, num_heads=4,
           max_position=128)


def _loss_fn(out, label):
    return ((out - label) ** 2).mean()


def param_gap(got, want, init):
    """sum |got - want| over sum |want - init|: the gap as a share of how
    far the leaf moved (``chip_smoke.py``'s measure). AdamW's normalised
    update turns a gradient's last-bit difference on an element with a
    tiny second moment into a step-sized one, so an elementwise bound
    would measure that element, not the run."""
    moved = float(np.abs(np.asarray(want) - np.asarray(init)).sum())
    return float(np.abs(np.asarray(got) - np.asarray(want)).sum()) / max(
        moved, 1e-30)


def _data(step):
    rs = np.random.RandomState(step)
    return (paddle.to_tensor(rs.randn(BATCH, HID).astype("float32")),
            paddle.to_tensor(rs.randn(BATCH, HID).astype("float32")))


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


class _Cfg:
    pipeline_configs = {"accumulate_steps": MICRO,
                        "micro_batch_size": BATCH // MICRO}
    hybrid_configs = {}


def _jax_reference(steps=10):
    paddle.seed(42)
    model = JPipelineLayer([JLayerDesc(nn.Linear, HID, HID)
                            for _ in range(N_LAYERS)], num_stages=1,
                           loss_fn=_loss_fn)
    state = _state(model)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = []
    for step in range(steps):
        x, y = _data(step)
        total = 0.0
        for mx, my in zip(paddle.split(x, MICRO, axis=0),
                          paddle.split(y, MICRO, axis=0)):
            loss = _loss_fn(model(mx), my)
            (loss / MICRO).backward()
            total += float(loss)
        opt.step()
        opt.clear_grad()
        losses.append(total / MICRO)
    return state, losses, _state(model)


def _jax_pipeline(num_stages, interleave=False, steps=10):
    paddle.seed(42)
    model = JPipelineLayer([JLayerDesc(nn.Linear, HID, HID)
                            for _ in range(N_LAYERS)],
                           num_stages=num_stages, loss_fn=_loss_fn)
    cls = JInterleave if interleave else JPipelineParallel
    kw = {"virtual_pp_degree": 2} if interleave else {}
    pp = cls(model, hcg=None, strategy=_Cfg(), **kw)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = [float(pp.train_batch(_data(s), opt)) for s in range(steps)]
    return losses, _state(model)


def _jax_shared(num_stages):
    paddle.seed(7)
    descs = [JSharedLayerDesc("tied", nn.Linear, None, "weight", HID, HID),
             JLayerDesc(nn.Linear, HID, HID),
             JLayerDesc(nn.Linear, HID, HID),
             JSharedLayerDesc("tied", nn.Linear, None, "weight", HID, HID)]
    model = JPipelineLayer(descs, num_stages=num_stages, loss_fn=_loss_fn)
    state = _state(model)
    pp = JPipelineParallel(model, hcg=None, strategy=_Cfg())
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = [float(pp.train_batch(_data(s), opt)) for s in range(3)]
    return state, losses, _state(model)


def _jax_gpt(tied, ids, labels):
    """JAX's ``gpt_pipeline`` trained by the single-device micro-batch
    accumulation (JAX's own engine cannot be the reference here: at one
    stage it takes the gradient of the int ids, and across its devices
    its global-norm clip adds norms that live on different devices;
    ROADMAP C)."""
    paddle.seed(5)
    cfg = dict(GPT, tie_embeddings=tied, use_rope=tied)
    model = jgpt_pipeline(JGPTConfig(**cfg), num_stages=1)
    state = _state(model)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    losses = []
    for _ in range(3):
        total = 0.0
        for mx, my in zip(np.split(ids, MICRO), np.split(labels, MICRO)):
            loss = model.loss_fn(model(paddle.to_tensor(mx)),
                                 paddle.to_tensor(my))
            (loss / MICRO).backward()
            total += float(loss)
        opt.step()
        opt.clear_grad()
        losses.append(total / MICRO)
    return cfg, state, losses, _state(model)


@pytest.fixture(scope="module")
def runs():
    """JAX's runs, then one spawn of 4 gloo ranks running every body."""
    ref_state, ref_losses, ref_params = _jax_reference()
    jax_pp = {p: _jax_pipeline(p) for p in (2, 4)}
    jax_pp["vpp"] = _jax_pipeline(2, interleave=True)
    shared_state, shared_losses, shared_params = _jax_shared(2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, GPT["vocab_size"], (BATCH, 16))
    labels = np.roll(ids, -1, axis=1)
    gpt = {k: _jax_gpt(k == "tied", ids, labels) for k in ("tied",
                                                            "untied")}
    inputs = {"hid": HID, "n_layers": N_LAYERS, "micro": MICRO,
              "batch": BATCH, "stack_state": ref_state,
              "shared_state": shared_state, "gpt_ids": ids,
              "gpt_labels": labels, "clip": CLIP}
    for k, (cfg, state, _, _) in gpt.items():
        inputs[f"{k}_cfg"], inputs[f"{k}_state"] = cfg, state
    bodies = ["body_pp4", "body_pp4_m8", "body_pp2_dp2", "body_vpp2",
              "body_shared",
              "body_gpt_tied", "body_gpt_untied_mp", "body_pp_scaler"]
    ranks = dist_ranks.run_ranks(
        [f"dist_pipeline_bodies:{b}" for b in bodies], 4, inputs,
        deadline_s=240)
    got = {b: [r[f"dist_pipeline_bodies:{b}"] for r in ranks]
           for b in bodies}
    jax = {"ref": (ref_losses, ref_params), "pp": jax_pp,
           "shared": (shared_losses, shared_params),
           "gpt": {k: v[2:] for k, v in gpt.items()},
           "gpt_init": {k: v[1] for k, v in gpt.items()}}
    return jax, got


# ------------------------------------------------------------- streams
@pytest.mark.parametrize("gen", ["1f1b", "eager", "fthenb", "zbh1"])
def test_streams_equal_jax(gen):
    """Every generator's streams for p 1-4 and m 1-8 are JAX's."""
    pairs = {"1f1b": (jpipe._1f1b_instructions, tpipe._1f1b_instructions),
             "eager": (lambda p, m: jpipe._1f1b_instructions(p, m, 1),
                       lambda p, m: tpipe._1f1b_instructions(p, m, 1)),
             "fthenb": (jpipe._fthenb_instructions,
                        tpipe._fthenb_instructions),
             "zbh1": (jpipe._zb_h1_instructions,
                      tpipe._zb_h1_instructions)}
    j, t = pairs[gen]
    for p in range(1, 5):
        for m in range(1, 9):
            assert t(p, m) == j(p, m), (p, m)


def test_global_order_runs_every_op_after_its_producer():
    """The simulated order holds each stream's order, and every op comes
    after the op that produces its input."""
    for name in tpipe._SCHEDULES:
        for n in (1, 2, 4, 6):
            for m in (1, 3, 8):
                order = tpipe.global_order(n, m, name)
                pos = {o: i for i, o in enumerate(order)}
                gen = tpipe._SCHEDULES[name][0](n, m)
                for c, stream in enumerate(gen):
                    assert [(op, mb) for cc, op, mb in order if cc == c] \
                        == stream
                for (c, op, mb), i in pos.items():
                    if op == "F" and c > 0:
                        assert pos[(c - 1, "F", mb)] < i
                    if op == "B" and c < n - 1:
                        assert pos[(c + 1, "B", mb)] < i


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
def test_segment_layers_equal_jax(parts):
    for n in (4, 7, 8, 26):
        descs = list(range(n))
        assert (tpipe.SegmentLayers(descs, parts).do_segment()
                == JSegmentLayers(descs, parts).do_segment())


# ----------------------------------------------------------- the stack
@pytest.mark.parametrize("body,jax_key", [("body_pp4", 4),
                                          ("body_pp2_dp2", 2),
                                          ("body_vpp2", "vpp")])
def test_stack_matches_jax(runs, body, jax_key):
    jax, got = runs
    ref_losses, ref_params = jax["ref"]
    pp_losses, pp_params = jax["pp"][jax_key]
    for r in got[body]:
        np.testing.assert_allclose(r["losses"], pp_losses, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5,
                                   atol=1e-6)
    params = gather_parts([r["params"] for r in got[body]])
    assert set(params) == set(ref_params)
    for k, v in params.items():
        np.testing.assert_allclose(v, pp_params[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(v, ref_params[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_each_rank_holds_only_its_stage(runs):
    _, got = runs
    for r in got["body_pp4"]:
        s = r["stage"]
        assert r["keys"] == sorted(f"run_function.{i}.{w}"
                                   for i in (2 * s, 2 * s + 1)
                                   for w in ("weight", "bias"))
        assert r["chunks"] == [s]
    for r in got["body_vpp2"]:
        # 4 chunks of 2 layers, chunk c on stage c % 2
        s = r["stage"]
        assert r["chunks"] == [s, s + 2]
        assert {k.split(".")[1] for k in r["keys"]} == {
            str(i) for c in (s, s + 2) for i in (2 * c, 2 * c + 1)}
        assert r["schedule"] == "1F1B" and r["syncs"] == 10


def test_shared_layers_across_stages(runs):
    jax, got = runs
    losses, params = jax["shared"]
    for r in got["body_shared"]:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        # stage 0 and stage 1 hold a copy under its first use's name
        assert "run_function.0.shared.weight" in r["keys"]
    assert [r["shared_group"] for r in got["body_shared"]] == [
        [0, 2], [1, 3], [0, 2], [1, 3]]
    for rank, r in enumerate(got["body_shared"]):
        for k, (arr, _, _) in r["params"].items():
            np.testing.assert_allclose(arr, params[k], rtol=0, atol=1e-6,
                                       err_msg=f"rank {rank}: {k}")


@pytest.mark.parametrize("key,body", [("tied", "body_gpt_tied"),
                                      ("untied", "body_gpt_untied_mp")])
def test_gpt_pipeline_matches_jax(runs, key, body):
    jax, got = runs
    losses, params = jax["gpt"][key]
    for r in got[body]:
        assert r["clip"] == "HybridParallelClipGrad"
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
    whole = gather_parts([r["params"] for r in got[body]])
    assert set(whole) == set(params)
    init = jax["gpt_init"][key]
    for k, v in whole.items():
        assert param_gap(v, params[k], init[k]) <= 1e-3, k


def test_scaler_skips_a_non_finite_step_on_every_rank(runs):
    """One dp rank's inf reaches one stage's gradients only: found-inf is
    a max over the world, so all four ranks skip the step and halve the
    scale, then train on the next one."""
    _, got = runs
    for r in got["body_pp_scaler"]:
        assert r["unchanged"] and r["scale"] == 512.0 and r["moved"], r


# ----------------------------------------------------- the world-1 engine
def _port_stack(num_stages, schedule="1F1B", vpp=1, dropout=0.0):
    """The port's Linear stack (with dropout between layers) from one
    seed, under the in-process engine."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer

    descs = []
    for _ in range(4):
        descs.append(tpipe.LayerDesc(tnn.Linear, HID, HID))
        descs.append(tpipe.LayerDesc(tnn.Dropout, dropout))
    model = tpipe.PipelineLayer(descs, num_stages=num_stages,
                                loss_fn=_loss_fn)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p._value.copy_(torch.randn(p.shape, generator=g) * 0.3)

    class S:
        pipeline_configs = {"accumulate_steps": MICRO,
                            "schedule_mode": schedule}
        hybrid_configs = {"pp_configs": {"virtual_pp_degree": vpp}}

    wrapper = tpipe.PipelineParallel(model, strategy=S())
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    return model, wrapper, opt


def _port_accumulate(model, opt, x, y, gen):
    """The unpipelined micro-batch accumulation under the engine's random
    contract: micro-batch i's forward from the generator seeded with s + i
    (s one draw, ``micro_seed``)."""
    s = tpipe.micro_seed(gen)
    after = gen.get_state()
    total = 0.0
    for i, (mx, my) in enumerate(zip(x.chunk(MICRO), y.chunk(MICRO))):
        gen.manual_seed(s + i)
        loss = _loss_fn(model(mx), my)
        (loss / MICRO).backward()
        total = total + loss.detach()
    gen.set_state(after)
    opt.step()
    opt.clear_grad()
    return float(total / MICRO)


@pytest.mark.parametrize("schedule,vpp", [("1F1B", 1), ("ZB-H1", 1),
                                          ("FThenB", 1), ("Eager1F1B", 1),
                                          ("1F1B", 2)])
def test_world1_engine_with_dropout_matches_accumulation(on_cpu, schedule,
                                                        vpp):
    """At world size 1 every chunk runs in this process; with dropout 0.2
    the recomputed forwards replay the forward's masks and each micro-batch
    draws what its unpipelined forward draws: losses and parameters equal
    the plain accumulation's bit for bit over 3 steps."""
    from paddle_tpu_torch.framework import default_generator, seed

    seed(123)
    gen = default_generator("cpu")
    pipe, wrapper, opt = _port_stack(4, schedule, vpp, dropout=0.2)
    ref, _, ref_opt = _port_stack(1, dropout=0.2)
    for step in range(3):
        xj, yj = _data(step)
        x = torch.as_tensor(np.asarray(xj._value))
        y = torch.as_tensor(np.asarray(yj._value))
        state = gen.get_state()
        want = _port_accumulate(ref, ref_opt, x, y, gen)
        gen.set_state(state)
        got = float(wrapper.train_batch((x, y), opt))
        assert got == want, (step, got, want)
    for (k, a), (_, b) in zip(sorted(pipe.state_dict().items()),
                              sorted(ref.state_dict().items())):
        assert torch.equal(a._value, b._value), k
    assert wrapper._engine.schedule == schedule
    assert sorted(wrapper._engine.chunks) == list(range(4 * vpp))


def test_chunks_must_each_hold_a_layer(on_cpu):
    """More chunks than layers leaves an empty chunk, whose pass-through
    would hand the next chunk the int ids as its activation: refused."""
    from paddle_tpu_torch import nn as tnn

    model = tpipe.PipelineLayer([tpipe.LayerDesc(tnn.Linear, HID, HID)
                                 for _ in range(3)], num_stages=2,
                                loss_fn=_loss_fn)
    assert sorted(model.chunks(2)) == [0, 1]
    with pytest.raises(ValueError, match="do not fill 4"):
        model.chunks(4)


def test_world1_eval_batch_is_the_forward_loss(on_cpu):
    """``eval_batch`` runs only the forwards, in the global order of the
    F ops: the mean of the micro-batches' losses of the whole model's
    forward; with ``compute_loss=False`` the outputs, micro-batches in
    order."""
    pipe, wrapper, _ = _port_stack(4)
    ref, _, _ = _port_stack(1)
    xj, yj = _data(0)
    x = torch.as_tensor(np.array(xj._value))
    y = torch.as_tensor(np.array(yj._value))
    got = float(wrapper.eval_batch((x, y)))
    with torch.no_grad():
        want = sum(_loss_fn(ref(mx), my).float() for mx, my in
                   zip(x.chunk(MICRO), y.chunk(MICRO))) / MICRO
    assert got == pytest.approx(float(want), rel=1e-6)
    out = wrapper.eval_batch((x, y), compute_loss=False)
    with torch.no_grad():
        np.testing.assert_allclose(np.asarray(out._value), ref(x).numpy(),
                                   rtol=1e-6, atol=1e-6)



def test_sends_are_released_as_the_window_goes(runs):
    """A rank holds a send's tensor until a later micro-batch's B or W
    runs on it, not to the window's end: at pp 4 over 8 micro-batches the
    first stage holds, in the last window, at most the activations and
    generator states of its 1F1B warm-up and first forward (4
    micro-batches), of the 16 tensors it sends; every stage that sends
    holds fewer than it sends. The losses are the 4-micro-batch run's
    (the same rows, mean over equal micro-batches) within 1e-5."""
    _, got = runs
    ranks = got["body_pp4_m8"]
    for r in ranks:
        if r["stage"] < 3:
            assert r["held_peak"] < r["sent"], r
    assert ranks[0]["sent"] == 16 and ranks[0]["held_peak"] <= 2 * 4
    np.testing.assert_allclose(ranks[3]["losses"],
                               got["body_pp4"][3]["losses"][:2],
                               rtol=1e-5, atol=1e-6)
