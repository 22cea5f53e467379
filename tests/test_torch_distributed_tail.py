"""The last of ``paddle.distributed`` in the port against ``tests/
test_distributed_tail.py``'s bodies (``:81``, ``:127``, ``:138``,
``:176``): ``distributed.io`` (``save_persistables`` /
``load_persistables`` round trip, ``is_persistable``, the Program slot
refused), the sparse-table entry records, and the fleet datasets
(``InMemoryDataset`` / ``QueueDataset``: file feeding, the load / shuffle
/ release lifecycle, a ``pipe_command`` filter, an empty filter result, a
failing command, ``DataLoader`` interop, and a ``global_shuffle`` the same
for the same seed). Each body runs on both packages with the same files;
the port's answers are JAX's.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from port_bodies import on_cpu  # noqa: F401

PKGS = {"jax": paddle_tpu, "torch": paddle_tpu_torch}


def _weights(t):
    return np.asarray(getattr(t, "_value", t).detach()
                      if hasattr(getattr(t, "_value", t), "detach")
                      else getattr(t, "_value", t))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_distributed_io_roundtrip(pkg, tmp_path, on_cpu):
    P = PKGS[pkg]
    dist = P.distributed
    P.seed(0)
    m = P.nn.Linear(4, 4)
    w0 = _weights(m.weight).copy()
    dist.io.save_persistables(None, str(tmp_path), m)
    m2 = P.nn.Linear(4, 4)
    dist.io.load_persistables(None, str(tmp_path), m2)
    np.testing.assert_array_equal(_weights(m2.weight), w0)
    assert dist.io.is_persistable(m.weight)
    assert not dist.io.is_persistable(None)
    with pytest.raises(ValueError, match="no Program"):
        dist.io.save_persistables(None, str(tmp_path), None)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_entry_attr_records(pkg):
    dist = PKGS[pkg].distributed
    assert dist.ProbabilityEntry(0.1)._to_attr() == "probability_entry:0.1"
    assert dist.CountFilterEntry(10)._to_attr() == "count_filter_entry:10"
    assert dist.ShowClickEntry("show", "click")._to_attr() == \
        "show_click_entry:show:click"
    assert repr(dist.CountFilterEntry(3)) == "count_filter_entry:3"
    for bad in (lambda: dist.ProbabilityEntry(1.5),
                lambda: dist.ProbabilityEntry(1),
                lambda: dist.CountFilterEntry(-1),
                lambda: dist.ShowClickEntry("s", 3)):
        with pytest.raises(ValueError):
            bad()


def _files(tmp_path):
    f1 = tmp_path / "a.txt"
    f2 = tmp_path / "b.txt"
    f1.write_text("1 2\n3 4\n")
    f2.write_text("5 6\n")
    return str(f1), str(f2)


def _rows(ds):
    return [tuple(np.asarray(r).tolist()) for r in ds]


def _datasets_body(P, tmp_path):
    dist = P.distributed
    f1, f2 = _files(tmp_path)
    out = {}
    ds = dist.InMemoryDataset()
    ds.init(batch_size=2)
    ds.set_filelist([f1, f2])
    with pytest.raises(RuntimeError, match="load_into_memory"):
        list(ds)
    ds.load_into_memory()
    out["size"] = ds.get_memory_data_size()
    out["rows"] = sorted(_rows(ds))
    ds.local_shuffle()
    out["size_after_shuffle"] = ds.get_memory_data_size()
    ds.release_memory()
    out["released"] = ds.get_memory_data_size()
    qd = dist.QueueDataset()
    qd.init()
    qd.set_filelist([f1, f2])
    out["streamed"] = _rows(qd)
    qd2 = dist.QueueDataset()
    qd2.init(pipe_command="grep -v '^3'")
    qd2.set_filelist([f1])
    out["filtered"] = _rows(qd2)
    out["batches"] = len(list(P.io.DataLoader(qd, batch_size=2)))
    return out


def test_fleet_datasets_match_jax(tmp_path, on_cpu):
    got = _datasets_body(paddle_tpu_torch, tmp_path)
    want = _datasets_body(paddle_tpu, tmp_path)
    assert got == want
    assert got["rows"] == [(1.0, 2.0), (3.0, 4.0), (5.0, 6.0)]
    assert got["released"] == 0 and got["batches"] == 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fleet_dataset_edge_cases(pkg, tmp_path, on_cpu):
    P = PKGS[pkg]
    dist = P.distributed
    f1, _ = _files(tmp_path)
    qd = dist.QueueDataset()
    qd.init(pipe_command="grep nomatch")
    qd.set_filelist([f1])
    assert [r for r in qd] == []
    qbad = dist.QueueDataset()
    qbad.init(pipe_command="definitely-not-a-command-xyz")
    qbad.set_filelist([f1])
    with pytest.raises(RuntimeError, match="pipe_command"):
        [r for r in qbad]

    def shuffled_order():
        P.seed(1234)
        ds = dist.InMemoryDataset()
        ds.init()
        ds.set_filelist([f1])
        ds.load_into_memory()
        ds.global_shuffle()
        return _rows(ds)

    assert shuffled_order() == shuffled_order()
