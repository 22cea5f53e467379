"""``paddle.device`` and ``paddle.metric`` of the port against the JAX
package, on the CPU.

Metrics: ``tests/test_metrics_hapi.py``'s metric bodies (top-1 / top-k
``Accuracy``, ``Precision`` / ``Recall`` in closed form, ``Auc`` against
the rank-sum formula) and the ``accuracy`` functional, on both packages
(``port_bodies.run``: the port's values equal to the JAX package's).
Device: each function's answer for a host device, as the JAX package's
gives it (no card here: memory statistics 0 or empty, program-ordered
streams, events timed by the host clock); on the card ``chip_smoke.py``'s
``script`` phase holds the statistics to ``torch.cuda``'s.
"""
import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as port
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def accuracy_top1_and_topk(paddle):
    m = paddle.metric.Accuracy(topk=(1, 2))
    pred = np.array([[0.1, 0.7, 0.2], [0.8, 0.1, 0.1], [0.2, 0.3, 0.5],
                     [0.9, 0.05, 0.05]], "float32")
    label = np.array([[1], [2], [2], [0]])
    corr = m.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
    step = m.update(corr)
    top1, top2 = m.accumulate()
    names = m.name()
    m.reset()
    return {"corr": npy(corr), "step": step, "top1": top1, "top2": top2,
            "names": names, "reset": m.accumulate()}


def precision_recall_closed_form(paddle):
    p, r = paddle.metric.Precision(), paddle.metric.Recall()
    preds = np.array([0.9, 0.8, 0.2, 0.7, 0.1], "float32")
    labels = np.array([1, 0, 1, 1, 0])
    p.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
    r.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
    return {"p": p.accumulate(), "r": r.accumulate(), "pn": p.name(),
            "rn": r.name()}


def auc_rank_formula(paddle):
    rng = np.random.default_rng(0)
    scores = rng.uniform(0, 1, 200)
    labels = (scores + rng.normal(0, 0.3, 200) > 0.5).astype("int64")
    auc = paddle.metric.Auc()
    auc.update(paddle.to_tensor(scores.astype("float32")),
               paddle.to_tensor(labels))
    two = paddle.metric.Auc(num_thresholds=255)
    two.update(paddle.to_tensor(np.stack([1 - scores, scores], 1)
                                .astype("float32")),
               paddle.to_tensor(labels))
    order = np.argsort(scores)
    ranks = np.empty(200)
    ranks[order] = np.arange(1, 201)
    n_pos, n_neg = labels.sum(), (1 - labels).sum()
    want = (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (
        n_pos * n_neg)
    got = auc.accumulate()
    assert got == pytest.approx(want, abs=0.01)
    return {"auc": got, "two_col": two.accumulate()}


def accuracy_functional(paddle):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 10)).astype("float32")
    y = rng.integers(0, 10, (16, 1))
    return {f"top{k}": npy(paddle.metric.accuracy(
        paddle.to_tensor(x), paddle.to_tensor(y), k=k)) for k in (1, 3)}


BODIES = [accuracy_top1_and_topk, precision_recall_closed_form,
          auc_rank_formula, accuracy_functional]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_metric_body(on_cpu, body, pkg):
    run(body, pkg)


def test_accuracy_computes_on_the_predictions_device(on_cpu):
    import torch

    m = port.metric.Accuracy()
    pred = torch.tensor([[0.1, 0.9], [0.8, 0.2]])
    corr = m.compute(port.Tensor(pred), torch.tensor([[1], [1]]))
    assert isinstance(corr, port.Tensor)
    assert corr._value.device == pred.device
    assert m.update(corr) == 0.5


def test_device_answers_for_a_host_device(on_cpu):
    D, J = port.device, paddle_tpu.device
    assert D.get_all_device_type() == J.get_all_device_type() == ["cpu"]
    assert D.get_all_custom_device_type() == []
    assert D.synchronize() is None and J.synchronize() is None
    assert D.memory_stats() == J.memory_stats() == {}
    for name in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved"):
        assert getattr(D, name)() == 0          # no card, no allocator
        assert getattr(D.cuda, name)() == 0
        assert isinstance(getattr(J, name)(), int)
    D.empty_cache()
    D.cuda.empty_cache()
    assert D.cuda.device_count() == D.device_count() == 0
    for flag in ("is_compiled_with_rocm", "is_compiled_with_cinn",
                 "is_compiled_with_ipu", "is_compiled_with_custom_device"):
        assert getattr(D, flag)() is False is getattr(J, flag)()
    assert D.is_compiled_with_distribute() is True
    assert D.is_compiled_with_xpu() is False
    assert D.get_cudnn_version() is None


def test_streams_and_events_on_a_host_device(on_cpu):
    D = port.device
    s = D.current_stream()
    assert isinstance(s, D.Stream) and s.query()
    s.synchronize()
    other = D.Stream()
    other.wait_stream(s)
    e0 = D.Event()
    e0.record()
    time.sleep(0.01)
    e1 = other.record_event()
    e1.synchronize()
    other.wait_event(e1)
    assert e1.query() and e0.elapsed_time(e1) >= 10.0
    with D.stream_guard(other):
        assert isinstance(D.current_stream(), D.Stream)
    assert isinstance(D.set_stream(other), D.Stream)
    with pytest.raises(RuntimeError, match="recorded"):
        D.Event().elapsed_time(D.Event())
    assert D.cuda.Stream is D.Stream and D.cuda.Event is D.Event
