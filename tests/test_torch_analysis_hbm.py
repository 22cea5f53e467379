"""The HBM residency lint of the port (``paddle_tpu_torch.analysis.hbm``)
against the JAX package's (``tests/test_hbm_lint.py``).

* The estimator counts storages: exact on a single ``mm``, dead temps
  freed in a chain, nothing added for a view or an in-place update of an
  input, a donated input freed at its last use.
* ``per_block_bytes`` x (``num_blocks`` + 1) is what ``PagedKVCache``
  holds: the port's pool carries a scratch page past ``num_blocks``.
* ``plan_kv_pool`` and ``DeploymentPlan.to_json()`` equal JAX's on a grid
  of arguments, except for the scratch page, asserted exactly: where the
  reachable-set clamp binds, the same ``num_blocks`` and a ``kv_pool``
  component (and total) one page larger than JAX's; where the budget
  binds, one block fewer than JAX's and the same ``kv_pool`` bytes.
* The four rules give JAX's (rule, severity) sets on the same plan JSON,
  and each seeded fixture trips exactly its rule.
* The tiny GPT, carried across by ``bridge.py``, gets the same
  ``num_blocks`` from the port's and JAX's ``hbm_budget=`` schedulers when
  ``max_seq_len`` clamps the pool and one fewer in the port when the budget
  binds; both serve the same greedy tokens, and the gauges sum to the
  plan's total.

JAX's jaxpr estimator does not run on the installed JAX
(``tests/test_hbm_lint.py`` fails there too); its plan arithmetic, rules
and schedulers do, and those are what the port is held to.
"""
import copy
import json
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.analysis.hbm as JH
from paddle_tpu.analysis.compilesurface import ServingConfig as JConfig
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.analysis import hbm as H
from paddle_tpu_torch.analysis.__main__ import main as cli
from paddle_tpu_torch.analysis.compilesurface import ServingConfig
from paddle_tpu_torch.analysis.core import trace
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    PagedKVCache,
)
from paddle_tpu_torch.models import gpt as tgpt

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_FIXTURES = os.path.join(HERE, "hbm_fixtures")
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures", "hbm")
SMALL = dict(vocab_size=160, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_position=96)


# ----------------------------------------------------------------- estimator
def test_estimator_is_exact_on_a_single_mm():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    est = H.estimate_peak(trace(lambda a, b: a @ b, a, b), name="mm")
    want = (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert est.peak_bytes == want
    assert est.argument_bytes == (64 * 32 + 32 * 16) * 4
    assert est.output_bytes == 64 * 16 * 4
    assert est.to_memory_stats()["estimated"] is True


def test_chain_frees_dead_temps():
    x = torch.ones(256, 256)
    n = x.numel() * 4

    def chain(x):
        y = x * 2
        z = y + 1
        w = z * 3
        return w.sum()

    est = H.estimate_peak(trace(chain, x))
    # x is held; y dies once z exists, z once w exists: never 4 at once
    assert est.peak_bytes == 3 * n
    assert est.peak_bytes < 4 * n


def test_views_and_in_place_updates_of_an_input_add_nothing():
    x = torch.ones(256, 256)

    def views(x):
        v = x.view(-1)
        t = x.t()
        x.add_(1)
        v.mul_(2)
        return t

    est = H.estimate_peak(trace(views, x))
    assert est.peak_bytes == est.argument_bytes == x.numel() * 4
    assert est.output_bytes == x.numel() * 4       # the output IS x


def test_donated_input_is_freed_at_its_last_use():
    x = torch.ones(256, 256)
    n = x.numel() * 4
    gm = trace(lambda x: (x * 2) + 1, x)
    held = H.estimate_peak(gm)
    donated = H.estimate_peak(gm, donated=(True,))
    assert held.peak_bytes == 3 * n
    assert donated.peak_bytes == 2 * n
    assert donated.peak_bytes_undonated == held.peak_bytes
    assert donated.alias_bytes == n


def test_estimate_memory_stats_tiers():
    gm = trace(lambda a: a * 2, torch.ones(8, 8))
    st = H.estimate_memory_stats(gm)
    assert st["peak_bytes"] == 2 * 256 and st["estimated"]

    class Prog:
        memory = {"argument_bytes": 1024}

    assert H.estimate_memory_stats(compiled=Prog())["argument_bytes"] == 1024
    assert H.estimate_memory_stats() == {}


# ------------------------------------------------------------ plan arithmetic
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_holds_per_block_bytes_times_num_blocks_plus_one(dtype):
    kv = PagedKVCache(2, 4, 16, block_size=32, num_blocks=24, dtype=dtype,
                      device="cpu")
    pbb = H.per_block_bytes(kv.signature())
    assert pbb * (kv.num_blocks + 1) == kv.per_chip_pool_bytes()
    name = str(dtype).replace("torch.", "")
    assert pbb == JH.per_block_bytes((2, 4, 16, 32, 24, name))


GRID = [dict(budget=b, slots=s, max_seq_len=m, params_bytes=p,
             block_size=bs, prefix_blocks=pf)
        for b in (2 << 20, 6 << 20, 64 << 20)
        for s, m in ((4, 1024), (8, 512), (2, None))
        for p in (0, 1 << 20)
        for bs, pf in ((128, 0), (64, 2))]


def _plans(kw):
    args = dict(num_layers=2, num_kv_heads=4, head_dim=16,
                block_size=kw["block_size"], dtype="bfloat16",
                slots=kw["slots"], max_seq_len=kw["max_seq_len"],
                params_bytes=kw["params_bytes"],
                prefix_blocks=kw["prefix_blocks"], decode_kernel="kernel")
    out = []
    for mod in (JH, H):
        try:
            out.append(mod.plan_kv_pool(kw["budget"], **args))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_plan_kv_pool_equals_jax_up_to_the_scratch_page(kw):
    jax_s, port_s = _plans(kw)
    if isinstance(jax_s, ValueError):
        assert isinstance(port_s, ValueError)        # the port needs more
        return
    if isinstance(port_s, ValueError):
        # JAX fits exactly the floor; the port's scratch page does not fit
        assert jax_s["num_blocks"] == jax_s["fit_blocks"]
        return
    pbb = port_s["per_block_bytes"]
    assert pbb == jax_s["per_block_bytes"]
    assert port_s["target_blocks"] == jax_s["target_blocks"]
    assert port_s["fit_blocks"] == jax_s["fit_blocks"] - 1
    pj, jj = port_s["plan"].to_json(), jax_s["plan"].to_json()
    clamped = (port_s["target_blocks"] is not None
               and port_s["fit_blocks"] >= port_s["target_blocks"])
    want = copy.deepcopy(jj)
    if clamped:
        assert port_s["num_blocks"] == jax_s["num_blocks"]
        want["components"]["kv_pool"] += pbb
        want["planned_total_bytes"] += pbb
    else:
        assert port_s["num_blocks"] == jax_s["num_blocks"] - 1
        want["config"]["kv_signature"][4] -= 1
        assert pj["components"]["kv_pool"] == jj["components"]["kv_pool"]
    want["config"]["decode_kernel"] = "kernel"
    assert pj == want


def test_fit_bound_budget_takes_exactly_one_block_fewer():
    pbb = H.per_block_bytes((2, 4, 16, 128, 0, "bfloat16"))
    budget = int(10.5 * pbb / 0.92)
    j = JH.plan_kv_pool(budget, num_layers=2, num_kv_heads=4, head_dim=16,
                        block_size=128, slots=4, max_seq_len=256)
    p = H.plan_kv_pool(budget, num_layers=2, num_kv_heads=4, head_dim=16,
                       block_size=128, slots=4, max_seq_len=256)
    assert (j["num_blocks"], p["num_blocks"]) == (8, 8)   # clamped
    tight = int(6.5 * pbb / 0.92)
    j = JH.plan_kv_pool(tight, num_layers=2, num_kv_heads=4, head_dim=16,
                        block_size=128, slots=4, max_seq_len=256)
    p = H.plan_kv_pool(tight, num_layers=2, num_kv_heads=4, head_dim=16,
                       block_size=128, slots=4, max_seq_len=256)
    assert (j["num_blocks"], p["num_blocks"]) == (6, 5)   # fit-bound
    assert p["plan"].kv_pool_component == 6 * pbb == \
        j["plan"].kv_pool_component
    with pytest.raises(ValueError, match="cannot fit"):
        H.plan_kv_pool(3 * pbb, num_layers=2, num_kv_heads=4, head_dim=16,
                       block_size=128, slots=4, max_seq_len=1024)


# ----------------------------------------------------------------- the rules
def _plan_json(budget=8 << 20, params=0, slots=4, max_seq_len=1024, nb=32,
               programs=(), prefix_blocks=0):
    return {"config": {"name": "syn", "slots": slots,
                       "max_seq_len": max_seq_len,
                       "kv_signature": [2, 4, 16, 128, nb, "bfloat16"]},
            "budget_bytes": budget, "params_bytes": params,
            "prefix_blocks": prefix_blocks, "programs": list(programs)}


def _prog(name="p", peak=1 << 20, temp=1 << 19, largest=0, measured=None):
    return {"name": name, "peak_bytes": peak, "temp_bytes": temp,
            "largest_label": "aten.clone", "largest_bytes": largest,
            "largest_where": "", "measured_peak_bytes": measured}


PLANS = {
    "clean": _plan_json(),
    "over-budget": _plan_json(budget=2 << 20, params=1 << 20),
    "drift-in-band": _plan_json(programs=[_prog(measured=(3 << 20) // 2)]),
    "drift-out": _plan_json(programs=[_prog(peak=1 << 20,
                                            measured=8 << 20)]),
    "drift-floor": _plan_json(programs=[_prog(peak=1 << 18,
                                              measured=1 << 20)]),
    "oversized": _plan_json(programs=[_prog(largest=3 << 20)]),
    "misfit-short": _plan_json(nb=16),
    "misfit-waste": _plan_json(max_seq_len=None, nb=200),
    "parked": _plan_json(nb=40, prefix_blocks=8),
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_rules_give_jax_s_verdicts_on_the_same_plan_json(name, strict):
    spec = PLANS[name]
    port = H.analyze_hbm_plan(H.DeploymentPlan.from_json(spec),
                              strict=strict)
    jax_r = JH.analyze_hbm_plan(JH.DeploymentPlan.from_json(spec),
                                strict=strict)
    assert sorted((f.rule, f.severity) for f in port.findings) == sorted(
        (f.rule, f.severity) for f in jax_r.findings)


@pytest.mark.parametrize("name", ["clean_plan.json", "over_budget_plan.json",
                                  "pool_misfit.json"])
def test_jax_s_plan_fixtures_trip_the_same_rules(name):
    path = os.path.join(JAX_FIXTURES, name)
    port = H.hbm_fixture_reports(path)
    jax_r = JH.hbm_fixture_reports(path)
    assert [[(f.rule, f.severity) for f in r.findings] for r in port] == [
        [(f.rule, f.severity) for f in r.findings] for r in jax_r]


def test_torch_program_fixture_trips_oversized_temp_with_provenance():
    (report,) = H.hbm_fixture_reports(os.path.join(
        FIXTURES, "giant_temp_program.py"))
    assert [(f.rule, f.severity) for f in report.findings] == [
        ("oversized-temp", H.HIGH)]
    assert "16.0 MiB" in report.findings[0].message


def test_plan_json_roundtrip_components_and_unknown_fields():
    plan = H.DeploymentPlan.from_json(PLANS["parked"])
    js = plan.to_json()
    assert H.DeploymentPlan.from_json(js).to_json() == js
    assert sum(js["components"].values()) == js["planned_total_bytes"]
    pbb = plan.per_block_bytes
    assert js["components"]["kv_pool"] == (40 - 8 + 1) * pbb
    assert js["components"]["prefix_tier"] == 8 * pbb
    with pytest.raises(ValueError, match="unknown"):
        H.DeploymentPlan.from_json(dict(PLANS["clean"], bogus=1))
    assert js["comms"] is None
    cfg = ServingConfig.from_json(js["config"])
    assert cfg.to_json() == JConfig.from_json(js["config"]).to_json()


@pytest.fixture(scope="module")
def smoke():
    return H.smoke_plan(device="cpu")


def test_smoke_plan_is_clean_and_charges_the_pool_it_built(smoke):
    plan = smoke
    assert H.analyze_hbm_plan(plan).high() == []
    assert "hbm residency: hbm-smoke" in plan.render_table()
    nb = plan.num_blocks
    assert plan.kv_pool_component == (nb + 1) * plan.per_block_bytes
    assert [p.name for p in plan.programs] == ["prefill_chunk",
                                               "decode_step"]
    assert all(p.measured_peak_bytes is None for p in plan.programs)
    assert all(0 < p.temp_bytes < p.peak_bytes for p in plan.programs)


def test_cli_hbm_modes(capsys):
    assert cli(["--hbm", os.path.join(JAX_FIXTURES, "clean_plan.json")]) \
        == 0
    assert "CLEAN" in capsys.readouterr().out
    assert cli(["--hbm", FIXTURES]) == 1
    assert "oversized-temp" in capsys.readouterr().out
    assert cli(["--hbm", os.path.join(JAX_FIXTURES, "pool_misfit.json"),
                "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert [f["rule"] for r in payload["programs"]
            for f in r["findings"]] == ["pool-misfit"]
    assert cli(["--hbm", "no-such-config"]) == 2


# ------------------------------------------------- hbm_budget= schedulers
@pytest.fixture(scope="module")
def pair():
    with paddle.utils.unique_name.guard():
        paddle.seed(23)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = from_paddle_tpu_state(state, tgpt.GPTConfig(**SMALL), device="cpu")
    return jm, tm


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 160, n).astype(np.int64) for n in (5, 9, 3)]


def _serve(gp, prompts):
    out = [None] * len(prompts)

    def client(i):
        out[i] = np.asarray(gp.infer(prompts[i], timeout=120))

    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    return out


@pytest.fixture(scope="module")
def jax_served(pair):
    """JAX's hbm_budget= schedulers: num_blocks and greedy tokens, per
    budget."""
    jm, tm = pair
    out = {}
    for name, kw in _budgets(tm).items():
        jg = JaxContinuous(jm, decode_kernel="xla", **kw)
        try:
            out[name] = (jg.kv_cache.num_blocks, _serve(jg, _prompts()))
        finally:
            jg.close()
    return out


def _budgets(tm):
    pbb = H.per_block_bytes((2, 2, 16, 8, 0, "bfloat16"))
    base = dict(max_slots=2, prefill_chunk=4, decode_steps=2,
                max_new_tokens=5, block_size=8)
    fit = int((H.params_bytes_of(tm) + 40.5 * pbb) / 0.92)
    return {"clamped": dict(base, max_seq_len=32, hbm_budget=64 << 20),
            "fit-bound": dict(base, max_seq_len=None, hbm_budget=fit)}


@pytest.mark.parametrize("name, gap", [("clamped", 0), ("fit-bound", 1)])
def test_hbm_budget_schedulers_size_and_serve_as_jax_s(pair, jax_served,
                                                       name, gap):
    jm, tm = pair
    kw = _budgets(tm)[name]
    gp = ContinuousGenerateBatchingPredictor(tm, device="cpu", **kw)
    try:
        jb, jtoks = jax_served[name]
        assert jb - gp.kv_cache.num_blocks == gap
        if name == "clamped":
            assert gp.kv_cache.num_blocks == 2 * 4       # blocks_for(32, 8)
        plan = gp._hbm_plan
        assert plan.kv_pool_component == gp.kv_cache.per_chip_pool_bytes()
        assert plan.params_component == H.params_bytes_of(tm)
        toks = _serve(gp, _prompts())
        for got, want in zip(toks, jtoks):
            np.testing.assert_array_equal(got, want)
        fams = {f.name: f for f in gp.metrics.registry.families()}
        planned = {k: v for k, v in _series(
            fams["paddle_hbm_planned_bytes"]).items()}
        assert sum(planned.values()) == plan.planned_total_bytes
        assert set(planned) == set(plan.components())
        assert list(_series(fams["paddle_hbm_budget_bytes"]).values()) == [
            kw["hbm_budget"]]
    finally:
        gp.close()


def _series(family):
    """{first label value: value} of a gauge family."""
    out = {}
    for labels, child in family.children():
        out[labels[0]] = child.value
    return out


def test_gauges_absent_without_the_knob(pair):
    kv = PagedKVCache(*pair[1]._decode_cache_spec(), block_size=8,
                      num_blocks=16, device="cpu")
    gp = ContinuousGenerateBatchingPredictor(pair[1], kv_cache=kv,
                                             device="cpu", max_slots=2)
    try:
        names = {f.name for f in gp.metrics.registry.families()}
        assert "paddle_hbm_planned_bytes" not in names
        assert gp._hbm_plan is None
    finally:
        gp.close()
