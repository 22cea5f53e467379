"""The compile-surface lint of the port (``paddle_tpu_torch.analysis.
compilesurface``) against the JAX package's (``tests/test_compile_surface.
py``).

The AST pass over the port's ``models/generation.py`` finds JAX's five
decode paths (dense ``generate()``'s own key site, and the four paged
programs through ``_step_runner``), with no request component in the
step programs and the dense budget bucketed; the shipped configs' derived
inventory is closed over the default manifest; ``ServingConfig.program_keys``
of a live scheduler is what its warmup builds; ``ServingConfig`` and
``ProgramManifest`` JSON equal JAX's for the same fields; each seeded
fixture trips exactly its rule, as JAX's fixtures trip theirs. JAX's
answers are computed once in a module fixture.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.analysis.compilesurface as JCS
from paddle_tpu_torch.analysis import compilesurface as CS
from paddle_tpu_torch.analysis.__main__ import main as cli
from paddle_tpu_torch.analysis.findings import HIGH
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    PagedKVCache,
)
from paddle_tpu_torch.inference.warmup import Warmup
from paddle_tpu_torch.models import gpt as tgpt

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures", "surface")
JAX_FIXTURES = os.path.join(HERE, "compile_surface_fixtures")
STEP_PATHS = ("prefill_chunk", "decode_step", "verify_step")


@pytest.fixture(scope="module")
def jax_side():
    """JAX's schemas of its own source and its fixture verdicts."""
    schemas = JCS.extract_key_schemas()
    fixtures = {n: sorted({(f.rule, f.severity) for r in
                           JCS.surface_fixture_reports(
                               os.path.join(JAX_FIXTURES, n))
                           for f in r.findings})
                for n in ("bad_unbounded.py", "bad_manifest_missing.json",
                          "bad_dead_bucket.json", "_step_source.py")}
    return schemas, fixtures


@pytest.fixture(scope="module")
def schemas():
    return CS.extract_key_schemas()


def test_key_schemas_cover_jax_s_decode_paths(schemas, jax_side):
    assert set(schemas) == set(jax_side[0])
    assert {p: s.components[0].source for p, s in schemas.items()} == {
        p: repr(p) for p in schemas}
    # dense keys itself; the paged programs reach the one _step_runner site
    assert schemas["dense"].method == "generate"
    assert {schemas[p].method for p in ("paged",) + STEP_PATHS} == {
        "generate_paged", *STEP_PATHS}
    for p in ("paged",) + STEP_PATHS:
        assert schemas[p].extension == ("adapter_key_part(adapters)",)
    assert {p: s.arity for p, s in schemas.items()} == {
        "dense": 10, "paged": 11, "prefill_chunk": 10, "decode_step": 10,
        "verify_step": 10}


def test_runner_for_sites_are_counted_from_the_source():
    """Three text hits of ``_runner_for(`` (the method and its two call
    sites); the two sites give five schemas."""
    src = open(CS.GENERATION_SOURCE).read()
    assert src.count("_runner_for(") == 3
    assert src.count("= self._runner_for(") == 2


def test_no_request_component_in_step_programs(schemas, jax_side):
    for p in STEP_PATHS:
        assert schemas[p].request_components() == []
        assert jax_side[0][p].request_components() == []
    kinds = {c.source: c.kind for c in schemas["prefill_chunk"].components}
    assert kinds["S"] == kinds["C"] == kinds["NB"] == CS.SHAPE
    assert kinds["kv_cache.signature()"] == CS.CONFIG


def test_dense_budget_is_bucketed_and_paged_budget_pinned(schemas, jax_side):
    dense = {c.source: c.kind for c in schemas["dense"].components}
    assert dense["bucket"] == CS.BUCKETED
    assert any(c.kind == CS.BUCKETED
               for c in jax_side[0]["dense"].components)
    paged = schemas["paged"].request_components()
    assert [c.source for c in paged] == ["n"]
    report = CS.analyze_compile_surface()
    assert report.high() == []
    assert [(f.subject, e.reason) for f, e in report.suppressed] == [
        ("paged:n", CS._PAGED_PIN)]


def test_default_manifest_is_closed(schemas):
    manifest = CS.default_manifest()
    derived = [k for c in CS.default_serving_configs()
               for k in c.program_keys(schemas)]
    assert derived and all(manifest.covers(k) for k in derived)
    assert set(map(CS._freeze, manifest.programs)) == set(
        map(CS._freeze, derived))
    rep = CS.analyze_compile_surface(manifest=manifest)
    assert rep.findings == []
    assert CS.zoo_cross_check(schemas) == {
        p: CS.ZOO_FAMILIES[p] for p in schemas}


@pytest.fixture(scope="module")
def tiny():
    cfg = tgpt.GPTConfig(vocab_size=96, hidden_size=32, num_layers=2,
                         num_heads=2, max_position=64)
    return cfg, tgpt.GPTForCausalLM(cfg, device="cpu", seed=5)


@pytest.mark.parametrize("knobs", [dict(), dict(spec_k=2, eos_token_id=3),
                                   dict(adapters=True)])
def test_program_keys_are_what_the_live_warmup_builds(tiny, knobs):
    from paddle_tpu_torch.inference.adapters import AdapterRegistry

    cfg, model = tiny
    knobs = dict(knobs)
    if knobs.pop("adapters", False):
        knobs["adapters"] = AdapterRegistry(model, max_adapters=2,
                                            max_rank=4)
    kv = PagedKVCache(*model._decode_cache_spec(), block_size=8,
                      num_blocks=16, dtype=torch.float32, device="cpu")
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, device="cpu", max_slots=2, prefill_chunk=4,
        decode_steps=2, max_seq_len=32, **knobs)
    try:
        config = CS.ServingConfig.from_predictor(gp)
        keys = config.program_keys()
        stats = Warmup(gp).run()
        assert stats["missing"] == [] and stats["programs"] == len(keys)
        assert set(keys) <= set(model._runner_cache())
        assert [k[0] for k in keys] == list(config.active_paths())
    finally:
        gp.close()


def test_serving_config_and_manifest_json_equal_jax_s():
    fields = dict(name="json", slots=4, prefill_chunk=8, decode_steps=2,
                  spec_k=3, eos_token_id=7, max_seq_len=512,
                  kv_signature=(2, 4, 16, 32, 64, "bfloat16"),
                  decode_kernel="pallas", ids_dtype="int64",
                  paths=("prefill_chunk", "decode_step"),
                  adapter_signature=("lora", 5, 8, 4))
    port, jax_cfg = CS.ServingConfig(**fields), JCS.ServingConfig(**fields)
    assert port.to_json() == jax_cfg.to_json()
    assert CS.ServingConfig.from_json(jax_cfg.to_json()) == port
    assert port.table_width == jax_cfg.table_width
    assert port.active_paths() == jax_cfg.active_paths()
    programs = (("prefill_chunk", 4, 8, 16, (2, 4, 16, 32, 64, "bfloat16"),
                 7, "int64", "pallas", None),)
    pm = CS.ProgramManifest(name="m", programs=programs)
    jm = JCS.ProgramManifest(name="m", programs=programs)
    assert pm.to_json() == jm.to_json()
    assert CS.ProgramManifest.from_json(jm.to_json()) == pm
    with pytest.raises(CS.CompileSurfaceError, match="unknown"):
        CS.ServingConfig.from_json({"bogus": 1})


@pytest.mark.parametrize("name, rule", [
    ("bad_unbounded.py", "unbounded-key"),
    ("bad_manifest_missing.json", "manifest-incomplete"),
    ("bad_dead_bucket.json", "dead-bucket"),
    ("_step_source.py", None)])
def test_seeded_fixture_trips_exactly_its_rule(name, rule, jax_side):
    reports = CS.surface_fixture_reports(os.path.join(FIXTURES, name))
    got = sorted({(f.rule, f.severity) for r in reports
                  for f in r.findings})
    want = [] if rule is None else [(rule, HIGH)]
    assert got == want == jax_side[1][name]


def test_cli_surface_and_manifest(capsys):
    assert cli(["--surface"]) == 0
    assert "CLEAN" in capsys.readouterr().out
    assert cli(["--surface", FIXTURES]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert cli(["--manifest"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [c["name"] for c in out["configs"]] == [
        c.name for c in CS.default_serving_configs()]
    assert len(out["manifest"]["programs"]) == len(
        CS.default_manifest().programs)
    assert cli(["--manifest", "no-such-config"]) == 2


def test_drift_in_the_key_layout_is_manifest_incomplete(tmp_path):
    src = open(os.path.join(FIXTURES, "_step_source.py")).read()
    drifted = tmp_path / "drifted.py"
    drifted.write_text(src.replace('"int64",\n', '"int64", "extra",\n'))
    cfg = CS.ServingConfig(kv_signature=(2, 4, 16, 8, 16, "bfloat16"),
                           max_seq_len=16)
    rep = CS.analyze_compile_surface((cfg,), source=str(drifted))
    assert {f.rule for f in rep.high()} == {"manifest-incomplete"}
    assert "drift" in rep.high()[0].message
    np.testing.assert_array_equal(
        [len(s.components) for s in CS.extract_key_schemas(
            str(drifted)).values()], [11, 11, 11])
