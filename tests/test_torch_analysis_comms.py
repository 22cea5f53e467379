"""The port's comms lint (``paddle_tpu_torch/analysis/comms.py``) held to
JAX's (``paddle_tpu/analysis/comms.py``).

1. The JSON fixtures, copied byte for byte into
   ``tests/torch_analysis_fixtures/comms/``, give both packages the same
   findings.
2. The torch ``forced_reshard.py`` fixture (one ``all_to_all_single`` over
   a fake group of two ranks) gives exactly one ``implicit-reshard`` HIGH.
3. ``bytes_on_wire``, ``CommsBudget`` and the sampled-logits gather give
   JAX's numbers.
4. The ``gpt_tiny`` step programs traced at tp = 2 over torch's fake
   backend: collective kinds within ``SpecLayout.expected_collectives()``,
   input and output layouts equal to JAX's compiled shardings label by
   label, and the per-kind byte totals against JAX's compiled surfaces
   (computed once, in a module fixture, under the 8 host devices the
   conftest sets). The differences are by design and named where they are
   asserted.
5. ``DeploymentPlan.comms`` through JSON and ``analyze_hbm_plan``; the
   self-check's comms and tp entries clean with visible suppressions.
"""
import json
import os

import numpy as np
import pytest

import jax
import torch
import torch.distributed as dist

from paddle_tpu.analysis import comms as JC
from paddle_tpu_torch.analysis import comms as TC
from paddle_tpu_torch.analysis import hbm as TH
from paddle_tpu_torch.analysis.__main__ import main as cli
from paddle_tpu_torch.analysis.compilesurface import ServingConfig
from paddle_tpu_torch.analysis.findings import (Allowlist,
                                                stale_allowlist_findings)
from paddle_tpu_torch.distributed.mesh import SpecLayout

HERE = os.path.dirname(__file__)
JAX_FIXTURES = os.path.join(HERE, "comms_fixtures")
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures", "comms")
JSON_FIXTURES = sorted(n for n in os.listdir(JAX_FIXTURES)
                       if n.endswith(".json"))
PATHS = ("prefill_chunk", "decode_step", "verify_step")


def _keyed(report):
    return sorted((f.rule, f.severity, f.where, f.subject)
                  for f in report.findings)


# ------------------------------------------------------------ 1. fixtures
@pytest.mark.parametrize("name", JSON_FIXTURES)
def test_json_fixture_is_a_byte_copy_of_jax(name):
    with open(os.path.join(JAX_FIXTURES, name), "rb") as a, \
            open(os.path.join(FIXTURES, name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", JSON_FIXTURES)
def test_json_fixture_findings_match_jax(name):
    (want,) = JC.comms_fixture_reports(os.path.join(JAX_FIXTURES, name))
    (got,) = TC.comms_fixture_reports(os.path.join(FIXTURES, name))
    assert _keyed(got) == _keyed(want)
    assert got.name == want.name and got.rules_run == want.rules_run
    if name != "clean.json":
        assert got.findings


# ------------------------------------------------- 2. the torch fixture
def test_torch_forced_reshard_exactly_one_high():
    (r,) = TC.comms_fixture_reports(os.path.join(FIXTURES,
                                                 "forced_reshard.py"))
    assert [(f.rule, f.severity) for f in r.findings] == [
        ("implicit-reshard", "high")]
    assert "all-to-all f32[8] (group=2" in r.findings[0].message
    assert not dist.is_initialized()     # the fake group is gone


def test_an_unlisted_collective_is_inventoried_and_undeclared():
    """A collective outside JAX's five kinds (a broadcast) is not dropped:
    it is inventoried under its operator's name, which no layout
    declares."""
    from paddle_tpu_torch.analysis.core import trace

    def body(x):
        y = x * 2.0
        dist.broadcast(y, src=0)
        return y + 1.0

    with TC.tp_world(2):
        gm = trace(body, torch.ones(4, 8), stack_traces=True)
        s = TC.traced_comms_surface(gm, name="bcast")
    (op,) = s["ops"]
    assert (op.kind, op.result, op.group_size, op.buffer_bytes) == (
        "c10d.broadcast_", "f32[4,8]", 2, 128)
    r = TC.analyze_comms_surfaces(
        [s], expected=SpecLayout().expected_collectives(),
        allowlist=Allowlist([]))
    assert [(f.rule, f.severity) for f in r.findings] == [
        ("implicit-reshard", "high")]


def test_cli_comms_fixture_exit_codes(capsys):
    assert cli(["--comms", os.path.join(FIXTURES, "forced_reshard.py")]) == 1
    assert cli(["--comms", os.path.join(FIXTURES, "clean.json")]) == 0
    assert cli(["--comms", FIXTURES]) == 1
    assert cli(["--comms", "no_such_step"]) == 2
    assert "unknown step path" in capsys.readouterr().err


# ------------------------------------------------------- 3. the numbers
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_bytes_on_wire_matches_jax(kind):
    for nbytes in (0, 1, 8, 4096, 12345, 1 << 30):
        for group in (1, 2, 3, 4, 8):
            assert (TC.bytes_on_wire(kind, nbytes, group)
                    == JC.bytes_on_wire(kind, nbytes, group))


def test_comms_budget_matches_jax_and_round_trips():
    def build(m):
        return m.CommsBudget(
            tick_wall_s=0.1, ici_bytes_per_s=200e9,
            estimates=(m.CommsEstimate("prefill", 1000),
                       m.CommsEstimate("decode", 2048,
                                       launches_per_tick=2.0)))

    t, j = build(TC), build(JC)
    assert t.to_json() == j.to_json()
    assert (t.bytes_per_tick, t.wire_time_s(), t.share_of_tick()) == (
        j.bytes_per_tick, j.wire_time_s(), j.share_of_tick())
    assert TC.CommsBudget.from_json(json.loads(json.dumps(t.to_json()))) == t
    assert TC.CommsBudget(tick_wall_s=0.1).share_of_tick() is None
    with pytest.raises(ValueError, match="unknown CommsBudget"):
        TC.CommsBudget.from_json({"tick_wall_s": 0.1, "bytes_per_tick": 5})
    with pytest.raises(ValueError, match="unknown CommsEstimate"):
        TC.CommsEstimate.from_json({"name": "x", "bytes_per_launch": 1,
                                    "wire_time": 2})
    surfaces = [{"name": "prefill", "bytes_per_launch": 100,
                 "loop_steps": 1},
                {"name": "decode", "bytes_per_launch": 4096,
                 "loop_steps": 4}]
    assert (TC.smoke_comms_budget(surfaces, ici_bytes_per_s=1e9).to_json()
            == JC.smoke_comms_budget(surfaces,
                                     ici_bytes_per_s=1e9).to_json())


def test_interconnect_is_the_published_nvlink_figure_or_none():
    from paddle_tpu_torch.observability.device import (
        device_interconnect_bandwidth)

    assert device_interconnect_bandwidth("NVIDIA H100 80GB HBM3") == 450e9
    assert device_interconnect_bandwidth("cpu") is None
    assert device_interconnect_bandwidth("NVIDIA A100-SXM4-80GB") is None
    # off the table the budget rule is silent, as JAX's is off the TPU
    budget = TC.smoke_comms_budget([{"name": "d", "bytes_per_launch": 1 << 40,
                                     "device": "cpu"}])
    assert budget.ici_bytes_per_s is None
    assert list(TC._rule_comms_over_budget(budget)) == []


@pytest.fixture(scope="module")
def gathers():
    return (TC.sampled_logits_gather_surface(S=2, V=512, tp=2),
            JC.sampled_logits_gather_surface(S=2, V=512, tp=2))


def test_sampled_logits_gather_gives_jax_numbers(gathers):
    """One all-gather of S * V * 4 * (tp - 1) / tp bytes on wire in both.
    By design the port's program takes its shard ([S, V / tp], vocab cut
    over tp) where JAX's takes the whole logits and cuts them inside."""
    t, j = gathers
    assert len(t["ops"]) == len(j["ops"]) == 1
    (tg,), (jg,) = t["ops"], j["ops"]
    assert (tg.kind, tg.buffer_bytes, tg.wire_bytes, tg.group_size) == (
        jg.kind, jg.buffer_bytes, jg.wire_bytes, jg.group_size)
    assert t["bytes_per_launch"] == j["bytes_per_launch"] == 2 * 512 * 4 // 2
    assert tg.where.startswith("paddle_tpu_torch/")
    assert t["input_specs"] == {"logits": (None, "tp")}
    assert j["input_specs"] == {"logits": ()}


# ------------------------------------------ 4. the step programs at tp 2
def _jax_step_surface(path):
    """JAX's ``comms._build_step_program`` over the XLA attention route:
    its Pallas paged kernel needs ``jax.experimental.enable_x64``, which
    some JAX builds lack; the collectives do not depend on the route (the
    attention is head-local under shard_map either way)."""
    from paddle_tpu.analysis.zoo import _continuous_smoke
    from paddle_tpu.models.generation import step_arg_labels

    model, kv, tbl, ids, S, C, NEW, T, jnp = _continuous_smoke()
    pools = (tuple(kv.k_pages), tuple(kv.v_pages))
    temps = jnp.zeros((S,), jnp.float32)
    top_ks = jnp.zeros((S,), jnp.int32)
    state = model._decode_state(jnp.bfloat16)
    key = jax.random.key(0)

    def i32(a):
        return jnp.asarray(a, jnp.int32)

    lens0 = np.asarray([C, 0], np.int64)
    model.prefill_chunk(ids, np.zeros(S, np.int64), lens0, kv, tbl,
                        decode_kernel="xla")
    act = np.asarray([True, False])
    lmax = np.asarray([C + NEW, 0], np.int64)
    if path == "prefill_chunk":
        args = (state, jnp.asarray(ids), i32(np.zeros(S)), i32(lens0),
                i32(tbl), temps, top_ks, *pools, key)
        width, loop = C, 1
    elif path == "decode_step":
        tok = np.zeros(S, np.int64)
        model.decode_step(tok, lens0, act, kv, tbl, steps=T, max_lens=lmax,
                          decode_kernel="xla")
        args = (state, jnp.asarray(tok), i32(lens0), jnp.asarray(act),
                i32(lmax), i32(tbl), temps, top_ks, *pools, key)
        width, loop = T, T
    else:
        K = 3
        chunk = np.zeros((S, K + 1), np.int64)
        chunk[0] = np.random.RandomState(1).randint(0, 512, K + 1)
        dlens = np.asarray([K, 0], np.int64)
        model.verify_step(chunk, lens0, dlens, act, kv, tbl, max_lens=lmax,
                          decode_kernel="xla")
        args = (state, jnp.asarray(chunk), i32(lens0), i32(dlens),
                jnp.asarray(act), i32(lmax), i32(tbl), temps, top_ks,
                *pools, key)
        width, loop = K + 1, 1
    compiled = model.compiled_step_program(path, S, width, args)
    s = JC.compiled_comms_surface(compiled, name=path,
                                  labels=step_arg_labels(path), args=args,
                                  mesh_axes={"dp": 1, "tp": 2},
                                  loop_steps=loop)
    s["width"] = width
    return s


@pytest.fixture(scope="module")
def jax_surfaces():
    from paddle_tpu.distributed.mesh import get_mesh, serving_mesh, set_mesh

    if len(jax.devices()) < 2:
        pytest.skip("JAX's tp=2 reference needs the conftest's 8 host "
                    "devices")
    prev = get_mesh()
    serving_mesh(dp=1, tp=2)
    try:
        return {p: _jax_step_surface(p) for p in PATHS}
    finally:
        set_mesh(prev)


@pytest.fixture(scope="module")
def port_surfaces():
    from paddle_tpu_torch.distributed.mesh import get_mesh

    before = get_mesh()
    surfaces = TC.step_comms_surfaces(device="cpu")
    assert get_mesh() is before     # the serving mesh is put back
    report = TC.analyze_step_comms(_surfaces=surfaces)
    return {s["path"]: s for s in surfaces}, report


@pytest.mark.parametrize("adapters", [False, True])
@pytest.mark.parametrize("path", PATHS)
def test_step_arg_labels_match_jax(path, adapters):
    """The port's step_arg_labels are JAX's; every runner input the comms
    surface labels maps onto one of them."""
    from paddle_tpu.models.generation import step_arg_labels as jax_labels
    from paddle_tpu_torch.models.generation import (STEP_INPUT_LABELS,
                                                    step_arg_labels)

    labels = step_arg_labels(path, adapters=adapters)
    assert labels == jax_labels(path, adapters=adapters)
    names = set(STEP_INPUT_LABELS[path].values())
    assert names <= set(step_arg_labels(path, adapters=True))
    assert set(labels) - {"state", "k_pages", "v_pages", "bank"} <= (
        names | {"adapter_slots"})


def test_fake_group_is_scoped_to_the_trace(port_surfaces):
    surfaces, _ = port_surfaces
    assert not dist.is_initialized()
    assert {s["tp"] for s in surfaces.values()} == {2}
    assert all(s["loop_steps"] == 1 for s in surfaces.values())


@pytest.mark.parametrize("path", PATHS)
def test_step_collectives_are_declared_kinds(path, port_surfaces):
    surfaces, _ = port_surfaces
    kinds = {op.kind for op in surfaces[path]["ops"]}
    assert kinds == {"all-reduce", "all-gather"}
    assert kinds <= set(SpecLayout().expected_collectives())
    for op in surfaces[path]["ops"]:
        assert op.group_size == 2 and op.count == 1
        assert op.where.startswith("paddle_tpu_torch/"), op.where
        assert op.op_name in ("c10d.allreduce_", "c10d.allgather_")


@pytest.mark.parametrize("path", PATHS)
def test_step_layouts_match_jax_label_by_label(path, port_surfaces,
                                               jax_surfaces):
    surfaces, _ = port_surfaces
    t, j = surfaces[path], jax_surfaces[path]
    norm = TC._normalize_spec
    assert {k: norm(v) for k, v in t["input_specs"].items()} == {
        k: norm(v) for k, v in j["input_specs"].items()}
    assert {k: norm(v) for k, v in t["output_specs"].items()} == {
        k: norm(v) for k, v in j["output_specs"].items()}


def _forward_all_reduces(ops, hidden=64):
    """(elements x count) of the all-reduces whose buffer ends in the
    hidden width: the row-parallel and vocab-parallel partial sums."""
    out = []
    for op in ops:
        dims = JC._HLO_TYPE_RE.findall(op.result)
        shape = [int(d) for d in dims[0][1].split(",") if d] if dims else []
        if op.kind == "all-reduce" and shape and shape[-1] == hidden:
            out += [int(np.prod(shape))] * op.count
    return sorted(out)


@pytest.mark.parametrize("path", PATHS)
def test_step_bytes_against_jax(path, port_surfaces, jax_surfaces):
    """Per kind, against JAX's compiled surface:

    * all-reduce: the same partial sums (the embedding lookup and each
      layer's out_proj and down), per decode step, of the same sizes; the
      port reduces them in the activation dtype (bf16), JAX's partitioner
      in f32, so the port's bytes are half of JAX's. JAX also all-reduces
      a few sampler values over the vocab shards; the port samples from
      the whole row and has none.
    * all-gather: the port gathers the whole vocabulary row of logits
      before it samples (S x width x V, bf16); JAX samples over the vocab
      shards and gathers only per-shard maxima and their indices.
    * collective-permute and all-to-all: JAX's qkv / swiglu straddles and
      its distributed top-k sort; the port cuts its fused projections per
      head group and per half, and sorts a whole row, so it has neither.
    """
    surfaces, _ = port_surfaces
    t, j = surfaces[path], jax_surfaces[path]
    t_fwd, j_fwd = _forward_all_reduces(t["ops"]), _forward_all_reduces(
        j["ops"])
    assert t_fwd and t_fwd == j_fwd
    t_ar = sum(op.wire_bytes for op in t["ops"] if op.kind == "all-reduce")
    j_ar = sum(op.wire_bytes for op in j["ops"]
               if op.kind == "all-reduce"
               and op.result.endswith(",64]"))
    assert 2 * t_ar == j_ar
    S, V = 2, 512
    steps = j["loop_steps"]
    width = 1 if path == "decode_step" else j["width"]
    gathered = sum(op.buffer_bytes for op in t["ops"]
                   if op.kind == "all-gather")
    assert gathered == steps * S * width * V * 2
    assert {op.kind for op in j["ops"]} - {op.kind for op in t["ops"]} == {
        "collective-permute", "all-to-all"}
    assert t["bytes_per_launch"] == sum(op.wire_bytes for op in t["ops"])


def test_step_budget_tick_matches_jax(port_surfaces, jax_surfaces):
    """The zoo budget's tick wall is the decode program's steps times the
    TPOT objective in both (JAX reads its scan length, the port its
    unrolled steps); off the card neither has an interconnect figure."""
    surfaces, _ = port_surfaces
    t = TC.smoke_comms_budget(list(surfaces.values()))
    j = JC.smoke_comms_budget(list(jax_surfaces.values()))
    assert t.tick_wall_s == j.tick_wall_s == 2 * TC.DEFAULT_TPOT_BUDGET_S
    assert t.ici_bytes_per_s is None and j.ici_bytes_per_s is None
    assert [e.name for e in t.estimates] == [
        "gpt.decode.paged_prefill_chunk_tp", "gpt.decode.paged_step_tp",
        "gpt.decode.paged_verify_step_tp"]


def test_step_report_is_clean_with_the_dp_axis_visible(port_surfaces):
    _, report = port_surfaces
    assert report.findings == []
    assert [(f.rule, e.contains) for f, e in report.suppressed] == [
        ("dead-mesh-axis", "'dp'")]
    assert stale_allowlist_findings([("comms",
                                      TC.BUILTIN_COMMS_ALLOWLIST)]) == []


def test_render_comms_table_lists_every_collective(port_surfaces):
    surfaces, _ = port_surfaces
    table = TC.render_comms_table(list(surfaces.values()))
    assert "gpt.decode.paged_step_tp (tp=2)" in table
    n = sum(len(s["ops"]) for s in surfaces.values())
    assert table.count(" on wire  @ ") == n
    assert "models/generation.py" in table     # the sampled-logits gather


def test_serving_surfaces_build_runners_without_running(monkeypatch):
    """``serving_comms_surfaces`` (the card's full-width leg): each step
    call builds its runner and runs nothing; the surfaces hold the same
    collectives as the zoo's."""
    from paddle_tpu_torch.jit import graphs
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.inference import PagedKVCache

    runs = []
    real = graphs.StepRunner.run
    monkeypatch.setattr(graphs.StepRunner, "run",
                        lambda self, *a, **k: (runs.append(a),
                                               real(self, *a, **k))[1])
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_position=128)
    with TC.tp_world(2) as axes:
        m = GPTForCausalLM(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
        m.eval()
        kv = PagedKVCache(2, 2, 16, block_size=16, num_blocks=8,
                          device="cpu")
        config = ServingConfig(name="tiny", slots=2, prefill_chunk=8,
                               decode_steps=2, max_seq_len=32, spec_k=2,
                               kv_signature=kv.signature())
        surfaces = TC.serving_comms_surfaces(m, kv, config, mesh_axes=axes)
        assert "_run_step" not in vars(m)
    assert runs == []
    assert [s["path"] for s in surfaces] == list(PATHS)
    counts = [len(s["ops"]) for s in surfaces]
    assert counts == [6, 12, 6]         # 5 all-reduces + 1 gather a step
    assert surfaces[1]["decode_steps"] == 2
    assert TC.smoke_comms_budget(surfaces).tick_wall_s == 0.1


# ----------------------------------- 5. the plan and the self-check
def _plan(comms=None):
    cfg = ServingConfig(name="syn", slots=4, max_seq_len=1024,
                        kv_signature=(2, 4, 16, 128, 32, "bfloat16"))
    return TH.DeploymentPlan(config=cfg, budget_bytes=8 << 20, comms=comms)


def test_plan_comms_round_trips_and_stays_out_of_residency():
    comms = TC.CommsBudget(tick_wall_s=0.2, ici_bytes_per_s=450e9,
                           estimates=(TC.CommsEstimate("decode", 77),))
    plan, bare = _plan(comms), _plan()
    js = json.loads(json.dumps(plan.to_json()))
    assert js["comms"] == comms.to_json()
    assert TH.DeploymentPlan.from_json(js).comms == comms
    assert plan.components() == bare.components()
    assert "comms" in plan.render_table()
    assert "comms" not in bare.render_table()
    js["comms"]["made_up"] = 1
    with pytest.raises(ValueError, match="unknown CommsBudget"):
        TH.DeploymentPlan.from_json(js)


def test_analyze_hbm_plan_runs_the_comms_arm():
    est = (TC.CommsEstimate("decode", 1_000_000),)
    over = TC.CommsBudget(tick_wall_s=0.001, ici_bytes_per_s=1000.0,
                          estimates=est)
    r = TH.analyze_hbm_plan(_plan(over), allowlist=Allowlist([]))
    assert [f.rule for f in r.high()] == ["comms-over-budget"]
    assert r.high()[0].subject == "syn:comms"
    ok = TC.CommsBudget(tick_wall_s=0.1, ici_bytes_per_s=1e12, estimates=est)
    assert TH.analyze_hbm_plan(_plan(ok), allowlist=Allowlist([])).findings \
        == []
    assert "comms-over-budget" not in TH.analyze_hbm_plan(_plan()).rules_run


def test_self_check_tp_and_comms_entries_clean(capsys):
    assert cli(["--self-check", "--json", "--device", "cpu", "--programs",
                "gpt_decode_step_tp,comms_surface"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "ok" and out["high_total"] == 0
    names = [p["program"] for p in out["programs"]]
    assert names == ["gpt.decode.paged_step_tp", "comms.surface"]
    comms = out["programs"][1]
    assert [s["finding"]["rule"] for s in comms["suppressed"]] == [
        "dead-mesh-axis"]
    assert all(s["reason"] for p in out["programs"]
               for s in p["suppressed"])
    assert not torch.distributed.is_initialized()
