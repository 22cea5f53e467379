"""Pipeline schedules beyond 1F1B on the port — JAX's
``tests/test_pipeline_schedules.py`` bodies: the FThenB, Eager1F1B and
ZB-H1 stream shapes and name normalisation (its errors too) on the
port's own copies, per-schedule loss parity (every schedule and VPP 2
over pp 2 x dp 2 on 4 gloo ranks, 5 SGD steps, against JAX's
single-device micro-batch accumulation and JAX's engine under the same
schedule, rtol 1e-5, atol 1e-6) and ``schedule_mode`` through the fleet
wrapper (``fleet.init`` + ``distributed_model``)."""
import numpy as np
import pytest

import dist_ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc,
    PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel,
)

from paddle_tpu_torch.distributed.fleet.pipeline import (
    _1f1b_instructions, _fthenb_instructions, _normalize_schedule,
    _zb_h1_instructions,
)

P, M = 4, 8
HID, BATCH, MICRO, N_BLOCKS, STEPS = 16, 8, 4, 4, 5
SCHEDULES = [("1F1B", "1F1B", 1), ("FThenB", "FThenB", 1),
             ("Eager1F1B", "Eager1F1B", 1), ("ZB-H1", "ZB-H1", 1),
             ("vpp", "vpp", 2)]


# ------------------------------------------------------------------ streams
def test_fthenb_stream_shape():
    streams = _fthenb_instructions(P, M)
    for ops in streams:
        assert ops == ([("F", i) for i in range(M)]
                       + [("B", i) for i in range(M)])


def test_eager_1f1b_stream_shape():
    eager = _1f1b_instructions(P, M, warmup_extra=1)
    plain = _1f1b_instructions(P, M)

    def warmup(ops):
        n = 0
        for op, _ in ops:
            if op != "F":
                break
            n += 1
        return n

    for s in range(P):
        assert warmup(eager[s]) == min(P - s + 1, M)
        assert warmup(plain[s]) == min(P - s, M)
        assert warmup(eager[s]) == warmup(plain[s]) + 1
        for ops in (eager[s], plain[s]):
            assert sorted(mb for op, mb in ops if op == "F") == list(range(M))
            assert sorted(mb for op, mb in ops if op == "B") == list(range(M))


def test_zb_h1_stream_shape():
    streams = _zb_h1_instructions(P, M)
    for s, ops in enumerate(streams):
        fs = [mb for op, mb in ops if op == "F"]
        bs = [mb for op, mb in ops if op == "B"]
        ws = [mb for op, mb in ops if op == "W"]
        assert fs == list(range(M)) and bs == list(range(M))
        assert sorted(ws) == list(range(M))
        for i in range(M):
            assert ops.index(("W", i)) > ops.index(("B", i))
        n = 0
        for op, _ in ops:
            if op != "F":
                break
            n += 1
        assert n == min(P - s, M)
    assert ("W", 0) in streams[-1]


def test_schedule_name_normalization():
    assert _normalize_schedule("1F1B") == "1F1B"
    assert _normalize_schedule("fthenb") == "FThenB"
    assert _normalize_schedule("FThenB") == "FThenB"
    assert _normalize_schedule("eager_1f1b") == "Eager1F1B"
    assert _normalize_schedule("ZB-H1") == "ZB-H1"
    assert _normalize_schedule("zb_h1") == "ZB-H1"
    assert _normalize_schedule("zero_bubble") == "ZB-H1"
    assert _normalize_schedule("vpp") == "1F1B"
    with pytest.raises(ValueError):
        _normalize_schedule("nope")


# ------------------------------------------------------------------ parity
class _Block(nn.Layer):
    def __init__(self):
        super().__init__()
        self.up = nn.Linear(HID, HID * 2)
        self.down = nn.Linear(HID * 2, HID)

    def forward(self, x):
        return self.down(nn.functional.relu(self.up(x)))


def _loss_fn(out, label):
    return ((out - label) ** 2).mean()


def _data(step):
    rs = np.random.RandomState(100 + step)
    return (paddle.to_tensor(rs.randn(BATCH, HID).astype("float32")),
            paddle.to_tensor(rs.randn(BATCH, HID).astype("float32")))


def _model(num_stages):
    paddle.seed(11)
    return JPipelineLayer([JLayerDesc(_Block) for _ in range(N_BLOCKS)],
                          num_stages=num_stages, loss_fn=_loss_fn)


def _run_single():
    jdist.set_mesh(None)
    model = _model(1)
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = []
    for step in range(STEPS):
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
    return state, losses


def _jax_engine(schedule):
    class S:
        pipeline_configs = {"accumulate_steps": MICRO,
                            "schedule_mode": schedule}
        hybrid_configs = {}

    model = _model(2)
    pp = JPipelineParallel(model, hcg=None, strategy=S())
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    return [float(pp.train_batch(_data(s), opt)) for s in range(STEPS)]


@pytest.fixture(scope="module")
def runs():
    state, ref = _run_single()
    engine = {name: _jax_engine(sched) for name, sched, vpp in SCHEDULES
              if vpp == 1}
    inputs = {"hid": HID, "micro": MICRO, "batch": BATCH,
              "n_blocks": N_BLOCKS, "steps": STEPS, "sched_state": state,
              "schedules": SCHEDULES}
    ranks = dist_ranks.run_ranks(
        ["dist_pipeline_bodies:body_schedules",
         "dist_pipeline_bodies:body_fleet_schedule_mode"], 4, inputs)
    return ref, engine, ranks


@pytest.mark.parametrize("name,schedule,vpp", SCHEDULES)
def test_schedule_loss_parity(runs, name, schedule, vpp):
    ref, engine, ranks = runs
    for r in ranks:
        got = r["dist_pipeline_bodies:body_schedules"][name]
        np.testing.assert_allclose(got["losses"], ref, rtol=1e-5, atol=1e-6)
        if name in engine:
            np.testing.assert_allclose(got["losses"], engine[name],
                                       rtol=1e-5, atol=1e-6)
        assert got["schedule"] == _normalize_schedule(schedule)
        assert len(got["chunks"]) == vpp


def test_fleet_wrapper_schedule_mode(runs):
    _, _, ranks = runs
    for r in ranks:
        got = r["dist_pipeline_bodies:body_fleet_schedule_mode"]
        assert got["wrapper"] == "PipelineParallel"
        assert got["schedule"] == "ZB-H1" and got["mode"] == "pipeline"
        assert np.isfinite(got["loss"])
