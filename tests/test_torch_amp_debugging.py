"""``amp.debugging`` of the port against the JAX package on the CPU:
``tests/test_compat_io_debugging.py``'s debugging bodies on both packages
(operator stats, the tensor checker's flags, ``compare_accuracy``), the
operator-stats table of one forward of a two-layer ``nn.TransformerEncoder``
under O1 and O2 (the same weights), equal op by op and bucket by bucket to
JAX's, and ``gpt_tiny``'s table: the port's models record at their AMP
seams, so the table equals JAX's on the names both record, and the names
only JAX records are pinned (ROADMAP C). Tables are counts: compared
exactly.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.models import gpt as tgpt
from port_bodies import on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])
# the names JAX's gpt_tiny forward records that the port's seams do not:
# JAX dispatches its reshapes, its label mask's ``equal`` and the loss's
# ``squeeze`` / ``unsqueeze`` through apply_op; its CPU attention is the XLA
# route ``flash_attention`` where the port's CPU attention is the kernel
# route's seam, ``flash_attention_pallas`` (JAX's name on its kernel route)
GPT_ONLY_JAX = ["equal", "flash_attention", "reshape", "squeeze",
                "unsqueeze"]
GPT_ONLY_PORT = ["flash_attention_pallas"]


def _stats_body(P):
    dbg = P.amp.debugging
    x = P.to_tensor(np.ones((4, 4), "float32"))
    with dbg.collect_operator_stats():
        y = P.matmul(x, x)
        _ = P.add(y, y)
        with P.amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            _ = P.matmul(x, x)
        snap = dbg.operator_stats_snapshot()
    assert dbg.operator_stats_snapshot() == {}
    return {"snap": json.dumps(snap, sort_keys=True)}


@PKG
def test_operator_stats_collection(pkg, on_cpu, capsys):
    got = run(_stats_body, pkg)
    out = capsys.readouterr().out
    snap = json.loads(got["snap"])
    assert "matmul" in out and "op list" in out
    assert snap["matmul"] == {"float32": 1, "bfloat16": 1}


def _checker_body(P):
    dbg = P.amp.debugging
    flag = P.get_flags
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    on = flag(["FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level"])
    dbg.disable_tensor_checker()
    off = flag(["FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level"])
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=False))
    still = flag("FLAGS_check_nan_inf")
    return {"on": json.dumps(on, sort_keys=True),
            "off": json.dumps(off, sort_keys=True),
            "still": json.dumps(still, sort_keys=True)}


@PKG
def test_tensor_checker_flags(pkg):
    got = run(_checker_body, pkg)
    assert json.loads(got["on"])["FLAGS_check_nan_inf"] is True
    assert json.loads(got["on"])["FLAGS_check_nan_inf_level"] == 1
    assert json.loads(got["off"])["FLAGS_check_nan_inf"] is False


def test_tensor_checker_raises_at_level_0_and_warns_at_1(on_cpu):
    dbg = paddle_tpu_torch.amp.debugging
    x = paddle_tpu_torch.to_tensor(np.array([1.0, np.inf], "float32"))
    try:
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
        with pytest.raises(FloatingPointError, match="'exp'"):
            paddle_tpu_torch.exp(x)
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
        with pytest.warns(UserWarning, match="NaN/Inf"):
            out = paddle_tpu_torch.exp(x)
        assert np.isinf(out.numpy()[1])
    finally:
        dbg.disable_tensor_checker()


@PKG
def test_compare_accuracy(pkg, tmp_path):
    dbg = {"jax": paddle_tpu, "torch": paddle_tpu_torch}[pkg].amp.debugging
    a = {"matmul": {"float32": 3}, "add": {"float32": 1}}
    b = {"matmul": {"bfloat16": 3}, "add": {"float32": 1}}
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    out = tmp_path / "report.json"
    rows = dbg.compare_accuracy(str(pa), str(pb), str(out))
    assert [r["op"] for r in rows] == ["matmul"]
    report = json.loads(out.read_text())
    assert report["mismatched_ops"][0]["op"] == "matmul"
    assert report["num_ops_run1"] == 2


def _table(P, model, x, level, **kw):
    dbg = P.amp.debugging
    dbg.enable_operator_stats_collection()
    try:
        with P.amp.auto_cast(enable=True, level=level, dtype="bfloat16"):
            model(x, **kw)
        return dbg.operator_stats_snapshot()
    finally:
        dbg._stats = None


def _encoder(P):
    nn = P.nn
    P.seed(0)
    return nn.TransformerEncoder(
        nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0), 2)


LEVELS = ("O1", "O2")
XS = np.random.default_rng(0).standard_normal((2, 8, 32)).astype("float32")
IDS = np.random.default_rng(0).integers(0, 1024, (2, 16))


@pytest.fixture(scope="module")
def encoder_tables():
    """JAX's encoder state and its tables at both levels (its eager ops
    compile on first use: once a module)."""
    jm = _encoder(paddle_tpu)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return state, {level: _table(paddle_tpu, jm, paddle_tpu.to_tensor(XS),
                                 level) for level in LEVELS}


@pytest.mark.parametrize("level", LEVELS)
def test_encoder_table_equals_jax_op_by_op(on_cpu, encoder_tables, level):
    state, want = encoder_tables
    tm = _encoder(paddle_tpu_torch)
    tm.set_state_dict(state)
    got = _table(paddle_tpu_torch, tm, paddle_tpu_torch.to_tensor(XS), level)
    assert got == want[level]
    assert want[level]["linear"] == {"bfloat16": 12}
    assert want[level]["layer_norm"] == {"float32": 4}


@pytest.fixture(scope="module")
def gpt_pair():
    """The port's gpt_tiny on JAX's weights, and JAX's tables of one
    forward with labels at both levels."""
    with paddle_tpu.utils.unique_name.guard():
        paddle_tpu.seed(11)
        jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    ids = paddle_tpu.to_tensor(IDS)
    want = {level: _table(paddle_tpu, jm, ids, level, labels=ids)
            for level in LEVELS}
    return from_paddle_tpu_state(state, tgpt.gpt_tiny(), device="cpu"), want


@pytest.mark.parametrize("level", LEVELS)
def test_gpt_tiny_seams_equal_jax_on_shared_names(on_cpu, gpt_pair, level):
    tm, tables = gpt_pair
    want = tables[level]
    got = _table(paddle_tpu_torch, tm, torch.from_numpy(IDS), level,
                 labels=torch.from_numpy(IDS))
    shared = set(got) & set(want)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert sorted(set(want) - set(got)) == GPT_ONLY_JAX
    assert sorted(set(got) - set(want)) == GPT_ONLY_PORT
    assert got["flash_attention_pallas"] == want["flash_attention"]
    assert got["fused_rope"] == {"bfloat16": 2}


def test_collection_off_records_nothing(on_cpu):
    dbg = paddle_tpu_torch.amp.debugging
    assert dbg._stats is None
    x = paddle_tpu_torch.to_tensor(np.ones((2, 2), "float32"))
    paddle_tpu_torch.matmul(x, x)
    assert dbg.operator_stats_snapshot() == {}
