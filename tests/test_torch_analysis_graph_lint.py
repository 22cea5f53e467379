"""The graph lint of the port (``paddle_tpu_torch.analysis``: core, rules,
findings, zoo, CLI) against the JAX package's (``tests/test_graph_lint.py``
:32-176).

Every rule fires on a seeded torch program and stays quiet on its clean
twin, with the rule ids and severities JAX's analyzer gives the JAX seeded
program of the same hazard (JAX's answers computed once in a module
fixture). On the installed JAX, JAX's jaxpr rules do
not judge these programs (``jax.core.Jaxpr`` is gone: the rules crash into
``rule-error`` findings, and ``tests/test_graph_lint.py`` fails the same
way in the suite); where JAX's analyzer does judge, the port must agree
with it, and everywhere the port is held to the id and severity JAX's rule
declares (HIGH for every seeded hazard). The port's zoo programs are clean at high severity on the CPU;
``analyze_train_step`` changes nothing the step holds; the exported-program
entry (``jit.save``'s ``torch.export`` program) and the CLI run in
process.
"""
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.analysis as JA
import paddle_tpu_torch.analysis as A
from paddle_tpu_torch.analysis.__main__ import main as cli
from paddle_tpu_torch.analysis.zoo import ZOO_PROGRAMS

f32, bf16 = jnp.float32, jnp.bfloat16
RULES = ("donation-miss", "dtype-upcast", "host-sync", "constant-bloat",
         "recompile-hazard", "collective-axis")


def kinds(report):
    return sorted({(f.rule, f.severity) for f in report.findings})


def jax_kinds(report, rule):
    """JAX's (rule, severity) findings of ``rule`` on its seeded program,
    or None where the installed JAX's analyzer does not judge it (the rule
    crashed into a ``rule-error``, or its jaxpr walk found nothing)."""
    got = sorted({(f.rule, f.severity) for f in report.findings
                  if f.rule == rule})
    return got or None


@pytest.fixture(scope="module")
def jax_answers():
    """(rule, severity) sets JAX's analyzer gives its seeded programs."""
    out = {}

    def donate(state, x):
        return ({k: (v + x.sum()).astype(v.dtype) for k, v in state.items()},
                x.mean())

    out["donation-miss"] = JA.analyze(
        jax.jit(donate), {"w": jnp.zeros((512, 1024), f32)},
        jnp.ones((8,), f32))
    out["dtype-upcast"] = JA.analyze(
        jax.jit(lambda a, b: jnp.dot(a.astype(f32), b.astype(f32))),
        jnp.ones((4, 8), bf16), jnp.ones((8, 4), bf16))

    def hs(x):
        def body(c, _):
            jax.debug.print("c={c}", c=c)
            return c + 1, c
        return jax.lax.scan(body, x, None, length=3)

    out["host-sync"] = JA.analyze(jax.jit(hs), jnp.float32(1.0))
    big = np.ones((512, 1024), np.float32)
    out["constant-bloat"] = JA.analyze(
        jax.jit(lambda x: (x + jnp.asarray(big)).astype(x.dtype)),
        jnp.ones((512, 1024), f32), _donate_argnums=())

    class Cfg:
        pass

    out["recompile-hazard"] = JA.analyze(
        jax.jit(lambda x, cfg: x * 2, static_argnums=(1,)),
        jnp.ones((4,), f32), Cfg())
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:1]), ("mp",))
    sm = jax.jit(shard_map(lambda x: jax.lax.psum(x, "mp"), mesh=mesh,
                           in_specs=P("mp"), out_specs=P()))
    out["collective-axis"] = JA.analyze(sm, jnp.ones((8, 4), f32),
                                        _mesh_axes=("dp",))
    return {rule: jax_kinds(rep, rule) for rule, rep in out.items()}


@pytest.fixture()
def gloo_world():
    """A one-process gloo world (rank 0 of 1) and a second group over it:
    the collective-axis rule needs live group names, and spawns no rank.
    Per test: the tp entries below trace over a fake group of two ranks,
    which needs no default group alive."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    if made:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    other = dist.new_group([0])
    yield dist.group.WORLD, other
    if made:
        dist.destroy_process_group()


# ------------------------------------------------- seeded programs per rule
def _seeded(rule, world):
    """(program, args, kwargs) with the hazard, and its clean twin."""
    if rule == "donation-miss":
        state = {"w": torch.zeros(512, 1024)}                  # 2 MiB
        x = torch.ones(8)

        def bad(state, x):
            return {k: v + x.sum() for k, v in state.items()}, x.mean()

        def good(state, x):
            for v in state.values():
                v.add_(x.sum())
            return state, x.mean()
        return (bad, (state, x), {}), (good, (state, x), {})
    if rule == "dtype-upcast":
        a, b = torch.ones(4, 8, dtype=torch.bfloat16), torch.ones(
            8, 4, dtype=torch.bfloat16)
        return ((lambda a, b: a.float() @ b.float(), (a, b), {}),
                (lambda a, b: a @ b, (a, b), {}))
    if rule == "host-sync":
        x = torch.ones(4)

        def bad(x):
            return x * x.sum().item()    # reads device data on the host

        def good(x):
            return torch.where(x.sum() > 0, x * 2, x)
        return (bad, (x,), {}), (good, (x,), {})
    if rule == "constant-bloat":
        big = torch.ones(512, 1024)                            # 2 MiB
        x = torch.ones(8)
        return ((lambda x: x * big.mean(), (x,), {}),
                (lambda x, big: x * big.mean(), (x, big), {}))
    if rule == "recompile-hazard":
        class Cfg:                        # default identity hash / eq
            pass

        x = torch.ones(4)
        return ((lambda x, cfg: x * 2, (x, Cfg()), {}),
                (lambda x, cfg: x * 2, (x, ("frozen", 2)), {}))
    assert rule == "collective-axis"
    from torch.distributed import _functional_collectives as fc

    world, other = world

    def allreduce(x):
        return fc.all_reduce(x, "sum", other)
    x = torch.ones(8, 4)
    return ((allreduce, (x,), {"_mesh_axes": [world]}),
            (allreduce, (x,), {"_mesh_axes": [other]}))


@pytest.mark.parametrize("rule", RULES)
def test_rule_fires_on_seeded_program_and_not_on_its_twin(rule, jax_answers,
                                                          gloo_world):
    (bad, args, kw), (good, gargs, gkw) = _seeded(rule, gloo_world)
    r = A.analyze(bad, *args, _name=f"fix.{rule}", **kw)
    assert kinds(r) == [(rule, A.HIGH)]
    assert jax_answers[rule] in (None, [(rule, A.HIGH)])
    clean = A.analyze(good, *gargs, _name=f"fix.{rule}.ok", **gkw)
    assert [f for f in clean.findings if f.rule == rule] == []


def test_rule_messages_name_the_hazard(gloo_world):
    (bad, args, _), _ = _seeded("donation-miss", gloo_world)
    (f,) = A.analyze(bad, *args).findings
    assert "['w']" in f.message and "2.0 MiB" in f.message
    (bad, args, _), _ = _seeded("constant-bloat", gloo_world)
    (f,) = A.analyze(bad, *args).findings
    assert "2.0 MiB" in f.message
    (bad, args, _), _ = _seeded("dtype-upcast", gloo_world)
    assert "bfloat16" in A.analyze(bad, *args).findings[0].message


def test_dtype_upcast_follows_layout_ops_and_flags_f64():
    a = torch.ones(4, 8, dtype=torch.bfloat16)
    b = torch.ones(8, 4)
    r = A.analyze(lambda a, b: a.float().t().reshape(8, 4).t() @ b, a, b)
    assert [f.rule for f in r.findings] == ["dtype-upcast"]
    r2 = A.analyze(lambda x: x * 2.0, torch.ones(8, 8, dtype=torch.float64))
    assert kinds(r2) == [("dtype-upcast", A.HIGH)]
    assert "float64" in r2.findings[0].message


def test_host_sync_warns_off_the_hot_path_and_flags_item_nodes():
    x = torch.ones(4)
    r = A.analyze(lambda x: x * x.sum().item(), x, _hot=False)
    assert kinds(r) == [("host-sync", A.WARN)]
    assert "_local_scalar_dense" in r.findings[0].message
    # a value made from host data inside the program is not a sync
    r2 = A.analyze(lambda x: x * float(torch.tensor(0.5)), x)
    assert r2.findings == []

    def branchy(x):                     # the trace stops at the read
        return x * 2 if x.sum().item() > 0 else x
    r3 = A.analyze(branchy, x)
    assert ("host-sync", A.HIGH) in kinds(r3)


def test_recompile_hazard_static_numbers_and_closed_scalars():
    x = torch.ones(4)
    r = A.analyze(lambda x, opts: x * 2, x, {"mode": ["a", "b"]})
    assert ("recompile-hazard", A.HIGH) in kinds(r)
    assert "unhashable" in " ".join(f.message for f in r.findings)
    r2 = A.analyze(lambda x, s: x * s, x, 3.0)
    assert kinds(r2) == [("recompile-hazard", A.WARN)]
    s = torch.tensor(3.0)
    r3 = A.analyze(lambda x: x * s, x)
    assert any(f.rule == "recompile-hazard" and "closed over" in f.message
               for f in r3.findings)


def test_a_rule_that_crashes_is_an_info_finding(monkeypatch):
    from paddle_tpu_torch.analysis import rules

    def broken(prog):
        raise RuntimeError("boom")
    monkeypatch.setitem(rules.RULES, "host-sync", broken)
    r = A.analyze(lambda x: x + 1, torch.ones(2))
    assert kinds(r) == [("rule-error", A.INFO)]


# ----------------------------------------------------------------- allowlist
def test_allowlist_requires_reason_and_records_suppressions():
    with pytest.raises(ValueError, match="reason"):
        A.AllowlistEntry("donation-miss", reason="")
    entry = A.AllowlistEntry("donation-miss", subject="prog.*",
                             contains="pool", reason="intentional: xyz")
    f = A.Finding("donation-miss", A.HIGH, "pool not donated",
                  subject="prog.decode")
    other = A.Finding("host-sync", A.HIGH, "cb", subject="prog.decode")
    kept, suppressed = A.Allowlist([entry]).apply([f, other], backend="cpu")
    assert kept == [other] and suppressed == [(f, entry)]
    gated = A.AllowlistEntry("donation-miss", subject="prog.*",
                             reason="card only", backends=("cuda",))
    kept, suppressed = A.Allowlist([gated]).apply([f], backend="cpu")
    assert kept == [f] and suppressed == []
    kept, suppressed = A.Allowlist([gated]).apply([f], backend="cuda")
    assert kept == [] and suppressed == [(f, gated)]
    stale = A.stale_allowlist_findings([("graph", A.Allowlist(
        [A.AllowlistEntry("host-sync", reason="never used")]))])
    assert [(s.rule, s.severity) for s in stale] == [("allowlist-stale",
                                                      A.WARN)]
    assert all(e.reason for e in A.BUILTIN_ALLOWLIST)


# ----------------------------------------------------------------- the zoo
# the entries of the analysis port's second part (the tp step programs and
# the comms contract), checked on their own below
PART2_PROGRAMS = ("gpt_prefill_chunk_tp", "gpt_decode_step_tp",
                  "gpt_verify_step_tp", "comms_surface")
RUNNABLE = [n for n in ZOO_PROGRAMS if n not in PART2_PROGRAMS]


@pytest.fixture(scope="module")
def zoo():
    """Every runnable zoo entry's report, traced once for the module."""
    return {name: ZOO_PROGRAMS[name](device="cpu") for name in RUNNABLE}


@pytest.mark.parametrize("name", RUNNABLE)
def test_zoo_program_is_clean_at_high(name, zoo):
    r = zoo[name]
    assert r.high() == [], r.render()
    assert not any(f.rule == "rule-error" for f in r.findings), r.render()


@pytest.mark.parametrize("name", PART2_PROGRAMS)
def test_part2_zoo_entries_raise_naming_part_2(name):
    """The part-2 entries run now (they raised NotImplementedError before
    the thread and comms lints were ported): clean at high, no rule error,
    the fake process group gone after them; a tp program's all-reduces and
    logits gather are c10d nodes that collective-axis held to the serving
    mesh's groups."""
    import torch.distributed as dist

    r = ZOO_PROGRAMS[name](device="cpu")
    assert r.high() == [], r.render()
    assert not any(f.rule == "rule-error" for f in r.findings), r.render()
    assert not dist.is_initialized()
    if name.endswith("_tp"):
        assert r.name.endswith("_tp") and "collective-axis" in r.rules_run
    else:
        assert [f.rule for f, _e in r.suppressed] == ["dead-mesh-axis"]


# ----------------------------------------------------------- the train step
def test_analyze_train_step_changes_nothing_the_step_holds():
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.framework import default_generator
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    def build():
        cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                        num_heads=2, max_position=32, dropout=0.1)
        m = GPTForCausalLM(cfg, device="cpu", seed=3)
        opt = topt.AdamW(learning_rate=1e-3, parameters=m.parameters())
        return m, opt, TrainStep(m, lambda logits, loss: loss, opt)

    m, opt, step = build()
    _tm, _topt, twin = build()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 8)))
    labels = torch.roll(ids, -1, 1)
    # the two steps draw their dropout masks from the one CPU generator:
    # each pair of calls starts from the same generator state
    g = default_generator(torch.device("cpu"))
    g0 = g.get_state().clone()
    step(ids, labels=labels)
    g.set_state(g0)
    twin(ids, labels=labels)
    params = {k: v.detach().clone() for k, v in m.state_dict().items()}
    accs = {n: [t.clone() for t in s.values()]
            for n, s in opt._accumulators.items()}
    gen = default_generator(torch.device("cpu")).get_state().clone()
    rng = torch.get_rng_state()
    r = A.analyze_train_step(step, ids, labels=labels)
    assert r.name == "train_step:GPTForCausalLM" and r.high() == []
    assert opt._step_count == 1 and step._seed == 1
    assert torch.equal(default_generator(torch.device("cpu")).get_state(),
                       gen)
    assert torch.equal(torch.get_rng_state(), rng)
    for k, v in m.state_dict().items():
        assert torch.equal(v, params[k]), k
    for n, vals in accs.items():
        for a, b in zip(vals, opt._accumulators[n].values()):
            assert torch.equal(a, b)
    assert all(p.grad is None for p in m.parameters())
    got = step(ids, labels=labels)
    g.set_state(gen)
    assert torch.equal(got, twin(ids, labels=labels))


def test_train_step_graph_writes_its_state_in_place():
    from paddle_tpu_torch.analysis.core import _inputs_of, trace_train_step
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep

    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 4))
    opt = topt.Momentum(learning_rate=0.1, momentum=0.9,
                        parameters=m.parameters())
    step = TrainStep(m, torch.nn.functional.cross_entropy, opt,
                     split_label=True)
    x, y = torch.ones(3, 8), torch.zeros(3, dtype=torch.int64)
    gm, labels = trace_train_step(step, x, y)
    infos = {i.path: i.donated for i in _inputs_of(gm, labels)}
    assert infos["state['0.weight']"] and infos["acc['velocity']['0.weight']"]
    assert not infos["batch[a0]"]


# ---------------------------------------------------------- exported program
def test_exported_program_entry(tmp_path):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(16, 16)
            self.table = torch.ones(512, 1024)        # not state: baked

        def forward(self, x):
            return self.fc(x) + self.table[:1, :16]

    path = str(tmp_path / "head")
    jit.save(Head(), path, input_spec=[InputSpec([None, 16], "float32")])
    ep = torch.export.load(path + ".pdmodel")
    r = A.analyze_lowered(ep, name="exported.head")
    assert r.rules_run == ("donation-miss", "host-sync", "constant-bloat")
    assert kinds(r) == [("constant-bloat", A.HIGH)]
    ok = torch.nn.Linear(16, 16)
    jit.save(ok, str(tmp_path / "ok"),
             input_spec=[InputSpec([None, 16], "float32")])
    r2 = A.analyze_exported(torch.export.load(str(tmp_path / "ok.pdmodel")))
    assert r2.findings == []


# ---------------------------------------------------------------- the CLI
def test_cli_self_check_json_and_list_rules(capsys):
    assert cli(["--self-check", "--json", "--device", "cpu", "--programs",
                "gpt_prefill_chunk,compile_surface"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "ok" and out["high_total"] == 0
    assert [p["program"] for p in out["programs"]] == [
        "gpt.decode.paged_prefill_chunk", "compile.surface"]
    assert cli(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == (list(A.RULES) + list(A.THREAD_RULES)
                      + list(A.SURFACE_RULES) + list(A.HBM_RULES)
                      + list(A.COMMS_RULES))
    assert cli(["--programs", "no_such_program"]) == 2
    # the thread and comms legs are ported: they run, they do not raise
    assert cli(["--threads", A.lockwitness.__file__]) == 0
    assert cli(["--comms", "no_such_step"]) == 2
