"""HBM residency lint: a static peak-memory estimate and the deployment
budget — the counterpart of ``paddle_tpu/analysis/hbm.py``.

1. **The estimator** (``estimate_peak``) walks a traced FX graph
   (``core.trace``) in node order and tracks the live STORAGES, not the
   tensors: a view adds no bytes (it shares its base's storage), an
   in-place operator adds none (it writes a storage that is already live),
   and a storage dies after the last node that reads any tensor on it.
   Inputs are held to the program's end (the caller owns them; an input
   the program writes in place keeps its one storage) unless the caller
   declares them donated, in which case they are freed at their last use
   (JAX's donation). Constants and outputs are held to the end. A flat FX
   graph has no scan or cond, so nothing is recursed. The result is a
   ``peak_bytes`` watermark, the largest live buffers at the peak with
   their provenance, and a ``memory_stats``-shaped dict (``estimated``).
   Approximations: the walk follows the traced order, it never frees a
   temporary a kernel's fusion would elide (an over-estimate), and a port
   kernel's internal scratch (the attention kernels' split partials) is
   not in the graph (an under-estimate of a few MiB).

2. **The measured peak** (``measure_body_peak``, the other hand of
   ``estimate-drift``): on the card, the allocator's rise across an eager
   run of the program's body — ``torch.cuda.reset_peak_memory_stats()``,
   ``memory_allocated()`` before, ``max_memory_allocated()`` after, with
   the runner's bodies run uncaptured (``StepRunner._eager``) so the graph
   pool's allocations stay out of it — plus the bytes of the program's
   arguments, which are resident throughout, so that it is read in the
   estimate's frame. The CPU has no measured peak; the rule runs only
   where one exists.

3. **``DeploymentPlan``** — the per-chip residency of one
   ``ServingConfig``: params / tp, the ``PagedKVCache`` pool, a
   prefix-cache parked tier carved out of it, the largest temp watermark
   of the manifest programs and the resident adapter banks, against a
   budget with headroom. The port's pool holds ``num_blocks + 1`` pages
   (the last is the scratch page a fixed-length write drops its rows
   into, ``inference/kv_cache.py``), so ``kv_pool_component`` charges
   ``num_blocks - prefix_blocks + 1`` pages — what the device holds — and
   ``plan_kv_pool`` reserves the scratch page before it counts the blocks
   that fit. On a budget the fit binds, the port's pool is one block
   smaller than JAX's; on a budget the clamp binds it is JAX's.

Rules (JAX's ids, severities and thresholds, ``hbm.py:100-109``):
``hbm-over-budget`` (HIGH), ``estimate-drift`` (HIGH), ``oversized-temp``
(WARN; HIGH strict), ``pool-misfit`` (WARN; HIGH strict).

``plan_kv_pool`` is the runtime half: the continuous scheduler's
``hbm_budget=`` sizes its pool from the plan and publishes
``paddle_hbm_planned_bytes{component}`` beside
``paddle_hbm_budget_bytes``. ``DeploymentPlan.comms`` (a
``comms.CommsBudget``) carries the interconnect beside the residency: its
own table row and the ``comms-over-budget`` rule, never a component.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import torch

from .core import (Report, fmt_bytes, op_name, source_of, storages_of,
                   trace)
from .findings import HIGH, WARN, Allowlist, Finding

__all__ = [
    "HBM_RULES", "BUILTIN_HBM_ALLOWLIST", "PeakEstimate", "ProgramEstimate",
    "DeploymentPlan", "estimate_peak", "estimate_memory_stats",
    "measure_body_peak", "analyze_hbm_plan", "plan_kv_pool",
    "params_bytes_of", "blocks_for", "per_block_bytes", "smoke_plan",
    "smoke_budget_bytes", "hbm_fixture_reports", "analyze_hbm_residency",
]

HBM_RULES = {
    "hbm-over-budget":
        "the planned per-chip residency (params/tp + KV pool + prefix tier "
        "+ max program temp peak) exceeds budget x (1 - headroom) — the "
        "replica runs out of device memory before it serves",
    "estimate-drift":
        "the static peak estimate and the measured peak of the program's "
        "body diverge beyond tolerance — the plan's numbers are fiction "
        "until the estimator (or the trace) is fixed",
    "oversized-temp":
        "one live buffer at a program's static peak exceeds 25% of the "
        "budget — a recompute/chunking opportunity (HIGH in strict mode)",
    "pool-misfit":
        "the KV pool cannot cover max_slots x blocks_for(max_seq_len), or "
        ">30% of its blocks are unreachable by any admissible request",
}

DEFAULT_HEADROOM = 0.08           # fragmentation + allocator slack
OVERSIZED_TEMP_FRACTION = 0.25
POOL_WASTE_FRACTION = 0.30
DRIFT_REL_TOL = 1.0               # within 2x either way ...
DRIFT_ABS_FLOOR = 1 << 20         # ... above a 1 MiB absolute floor

# Ships EMPTY, as JAX's: the zoo residency entry is expected to be clean.
BUILTIN_HBM_ALLOWLIST = Allowlist([])


# ===================================================================== walk
class _Buf:
    """One live storage during the walk: bytes + provenance.
    ``kind``: argument | const | temp | output."""

    __slots__ = ("label", "bytes", "where", "kind")

    def __init__(self, label, nbytes, where, kind):
        self.label = label
        self.bytes = int(nbytes)
        self.where = where
        self.kind = kind

    def to_dict(self):
        return {"label": self.label, "bytes": self.bytes,
                "where": self.where, "kind": self.kind}


class PeakEstimate:
    """The estimator's verdict on one program. ``at_peak``: the live set
    (top-K by bytes) at the watermark; ``peak_bytes_undonated``: the walk
    with every input held to the end."""

    __slots__ = ("name", "peak_bytes", "peak_bytes_undonated",
                 "argument_bytes", "output_bytes", "alias_bytes",
                 "temp_bytes", "at_peak", "eqn_count")

    def __init__(self, name, peak_bytes, peak_bytes_undonated,
                 argument_bytes, output_bytes, alias_bytes, temp_bytes,
                 at_peak, eqn_count):
        self.name = name
        self.peak_bytes = int(peak_bytes)
        self.peak_bytes_undonated = int(peak_bytes_undonated)
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = int(output_bytes)
        self.alias_bytes = int(alias_bytes)
        self.temp_bytes = int(temp_bytes)
        self.at_peak = tuple(at_peak)
        self.eqn_count = int(eqn_count)

    @property
    def largest_temp(self):
        """(label, bytes, where) of the biggest non-argument buffer live at
        the peak, or None — the oversized-temp rule's subject."""
        temps = [b for b in self.at_peak if b.kind == "temp"]
        if not temps:
            return None
        top = max(temps, key=lambda b: b.bytes)
        return (top.label, top.bytes, top.where)

    def to_memory_stats(self) -> dict:
        """The ``memory_stats`` shape, estimated."""
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": 0,
            "alias_bytes": self.alias_bytes,
            "peak_bytes": self.peak_bytes,
            "estimated": True,
        }

    def to_dict(self) -> dict:
        out = self.to_memory_stats()
        out.update({
            "name": self.name,
            "peak_bytes_undonated": self.peak_bytes_undonated,
            "eqn_count": self.eqn_count,
            "at_peak": [b.to_dict() for b in self.at_peak],
        })
        return out


def _walk(gm, donated, arg_names):
    """Node-order liveness walk over the storages of one graph.
    Returns (peak, snapshot at the peak, argument bytes, output bytes,
    alias bytes, node count)."""
    nodes = list(gm.graph.nodes)
    phs = [n for n in nodes if n.op == "placeholder"]
    out_node = next((n for n in nodes if n.op == "output"), None)
    # every node's storages, and the last node reading each storage
    keys_of = {}
    for n in nodes:
        if n.op != "output":
            keys_of[n] = [(k, b) for k, b, _t in storages_of(
                n.meta.get("val"))]
    last = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            for k, _b in keys_of.get(a, ()):
                last[k] = i
    held = set()                    # storages kept to the end
    if out_node is not None:
        for a in out_node.all_input_nodes:
            held |= {k for k, _b in keys_of.get(a, ())}
    outputs = set(held)
    live, running = {}, 0
    argument = alias = 0
    donated = tuple(donated or ())
    for i, n in enumerate(phs):
        label = (arg_names[i] if arg_names and i < len(arg_names)
                 else n.name)
        for k, b in keys_of.get(n, ()):
            if k in live:
                continue
            live[k] = _Buf(label, b, "", "argument")
            running += b
            argument += b
            if i < len(donated) and donated[i]:
                alias += b
            else:
                held.add(k)
    consts = [n for n in nodes if n.op == "get_attr"]
    for n in consts:
        for k, b in keys_of.get(n, ()):
            if k not in live:
                live[k] = _Buf(str(n.target), b, "", "const")
                running += b
                held.add(k)
    peak, snapshot = running, list(live.values())
    count = 0
    for i, n in enumerate(nodes):
        if n.op not in ("call_function", "call_module", "call_method"):
            continue
        count += 1
        new = []
        for k, b in keys_of.get(n, ()):
            if k in live or any(k == nk for nk, _ in new):
                continue
            kind = "output" if k in outputs else "temp"
            new.append((k, _Buf(op_name(n), b, source_of(n), kind)))
        working = running + sum(buf.bytes for _, buf in new)
        if working > peak:
            peak = working
            snapshot = list(live.values()) + [buf for _, buf in new]
        for k, buf in new:
            live[k] = buf
            running += buf.bytes
        dead = {k for a in n.all_input_nodes for k, _b in keys_of.get(a, ())
                if last.get(k) == i and k in live and k not in held}
        dead |= {k for k, _b in keys_of.get(n, ())
                 if k not in last and k in live and k not in held}
        for k in dead:
            running -= live.pop(k).bytes
    output = 0
    seen = set()
    if out_node is not None:
        for a in out_node.all_input_nodes:
            for k, b in keys_of.get(a, ()):
                if k not in seen:
                    seen.add(k)
                    output += b
    return peak, snapshot, argument, output, alias, count


def estimate_peak(gm, *, donated=None, arg_names=None, name="program",
                  top_k=8) -> PeakEstimate:
    """Statically estimate the device-memory watermark of one traced
    program. ``donated``: per-placeholder flags of inputs the caller hands
    over (freed at their last use); ``top_k`` bounds the breakdown."""
    peak, snapshot, argument, output, alias, count = _walk(
        gm, donated, arg_names)
    if donated is not None and any(donated):
        undonated = _walk(gm, None, arg_names)[0]
    else:
        undonated = peak
    at_peak = sorted(snapshot, key=lambda b: -b.bytes)[:top_k]
    temp = sum(b.bytes for b in snapshot if b.kind == "temp")
    return PeakEstimate(name, peak, undonated, argument, output, alias,
                        temp, at_peak, count)


def estimate_memory_stats(gm=None, *, compiled=None, donated=None,
                          name="program") -> dict:
    """``memory_stats``-shaped dict from the estimator: the full tier with
    a traced graph; a degraded tier from a ``TrainStep`` ``StepProgram``'s
    ``memory`` (argument bytes, temps unknown). ``{}`` when neither
    yields anything."""
    if gm is not None:
        return estimate_peak(gm, donated=donated, name=name).to_memory_stats()
    mem = getattr(compiled, "memory", None) or {}
    argument = int(mem.get("argument_bytes", 0))
    if argument <= 0:
        return {}
    return {"argument_bytes": argument, "output_bytes": 0, "temp_bytes": 0,
            "generated_code_bytes": 0, "alias_bytes": 0,
            "peak_bytes": argument, "estimated": True}


def measure_body_peak(run, name="step", argument_bytes=0):
    """The measured peak of program ``name`` of ``run`` (a StepRunner) on
    the card: ``argument_bytes`` plus the allocator's rise across one eager
    run of the body under ``no_grad`` (from ``reset_peak_memory_stats``;
    the runner's bodies run uncaptured, so the graph pool stays out of
    it). The rise holds what aten allocates inside an operator (a column
    reduction's workspace), which no graph shows. None off the card."""
    if run.device.type != "cuda":
        return None
    dev = run.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    # the decode paths run their programs under no_grad, as the trace does
    with run.lock, run._eager(), torch.no_grad():
        run.run(name)
    torch.cuda.synchronize(dev)
    rise = torch.cuda.max_memory_allocated(dev) - before
    return int(argument_bytes) + int(rise)


# ================================================================= the plan
def blocks_for(seq_len, block_size) -> int:
    """PagedKVCache.blocks_for, pool-free (plan-time arithmetic)."""
    return max(1, math.ceil(int(seq_len) / int(block_size)))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).element_size()
    name = str(dtype).replace("torch.", "")
    return torch.empty(0, dtype=getattr(torch, name)).element_size()


def per_block_bytes(kv_signature, tp=1) -> int:
    """Per-chip bytes one pool page costs across K and V of every layer:
    2 * layers * (kv_heads / tp) * block_size * head_dim * itemsize; times
    ``num_blocks + 1`` it is ``PagedKVCache.per_chip_pool_bytes()``."""
    layers, kv_heads, head_dim, block_size, _nb, dtype = kv_signature[:6]
    tp = max(1, int(tp))
    heads = int(kv_heads) / tp if int(kv_heads) % tp == 0 else int(kv_heads)
    return int(2 * int(layers) * heads * int(block_size) * int(head_dim)
               * _itemsize(dtype))


@dataclasses.dataclass(frozen=True)
class ProgramEstimate:
    """One manifest program's contribution to the plan: the static peak /
    temp watermark, the largest single live buffer at the peak, and the
    measured peak where the card gave one."""
    name: str
    peak_bytes: int
    temp_bytes: int
    largest_label: str = ""
    largest_bytes: int = 0
    largest_where: str = ""
    measured_peak_bytes: object = None

    @classmethod
    def from_estimate(cls, est: PeakEstimate,
                      measured=None) -> "ProgramEstimate":
        top = est.largest_temp or ("", 0, "")
        return cls(name=est.name, peak_bytes=est.peak_bytes,
                   temp_bytes=est.temp_bytes, largest_label=top[0],
                   largest_bytes=top[1], largest_where=top[2],
                   measured_peak_bytes=measured)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "ProgramEstimate":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(f"unknown ProgramEstimate fields {unknown}; "
                             f"known: {sorted(known)}")
        return cls(**obj)


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    """Per-chip residency for one ServingConfig against a budget.

    Components are DISJOINT and sum to ``planned_total_bytes``;
    ``prefix_blocks`` is carved OUT of the pool. ``kv_pool`` charges the
    live blocks not parked plus the scratch page, what the device holds."""
    config: object
    budget_bytes: int
    headroom: float = DEFAULT_HEADROOM
    params_bytes: int = 0
    tp: int = 1
    prefix_blocks: int = 0
    programs: tuple = ()
    temps_bytes: int = 0
    adapter_bank_bytes: int = 0
    # the interconnect component (comms.CommsBudget or None), kept apart
    # from components(): bytes MOVED per tick, not bytes resident, so it
    # never enters the residency sum; its own row in render_table and its
    # own rule (comms-over-budget)
    comms: object = None

    def __post_init__(self):
        if self.budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        if not 0 <= self.headroom < 1:
            raise ValueError("headroom must be in [0, 1)")
        if self.prefix_blocks > self.num_blocks:
            raise ValueError(f"prefix_blocks {self.prefix_blocks} exceeds "
                             f"the pool ({self.num_blocks} blocks)")

    @property
    def num_blocks(self) -> int:
        return int(self.config.kv_signature[4])

    @property
    def per_block_bytes(self) -> int:
        return per_block_bytes(self.config.kv_signature, tp=self.tp)

    @property
    def usable_bytes(self) -> int:
        return int(self.budget_bytes * (1.0 - self.headroom))

    @property
    def params_component(self) -> int:
        return int(self.params_bytes) // max(1, int(self.tp))

    @property
    def kv_pool_component(self) -> int:
        # + 1: the scratch page the pool holds past num_blocks
        return (self.num_blocks - self.prefix_blocks + 1) * \
            self.per_block_bytes

    @property
    def prefix_tier_component(self) -> int:
        return self.prefix_blocks * self.per_block_bytes

    @property
    def temps_component(self) -> int:
        temps = [p.temp_bytes for p in self.programs]
        return max([int(self.temps_bytes)] + temps)

    @property
    def adapter_bank_component(self) -> int:
        return int(self.adapter_bank_bytes)

    def components(self) -> dict:
        return {
            "params": self.params_component,
            "kv_pool": self.kv_pool_component,
            "prefix_tier": self.prefix_tier_component,
            "temps": self.temps_component,
            "adapter_bank": self.adapter_bank_component,
        }

    @property
    def planned_total_bytes(self) -> int:
        return sum(self.components().values())

    def to_json(self) -> dict:
        return {
            "config": self.config.to_json(),
            "budget_bytes": int(self.budget_bytes),
            "headroom": float(self.headroom),
            "params_bytes": int(self.params_bytes),
            "tp": int(self.tp),
            "prefix_blocks": int(self.prefix_blocks),
            "programs": [p.to_json() for p in self.programs],
            "temps_bytes": int(self.temps_bytes),
            "adapter_bank_bytes": int(self.adapter_bank_bytes),
            "comms": self.comms.to_json() if self.comms else None,
            "components": self.components(),
            "planned_total_bytes": self.planned_total_bytes,
        }

    @classmethod
    def from_json(cls, obj) -> "DeploymentPlan":
        from .compilesurface import ServingConfig

        known = {f.name for f in dataclasses.fields(cls)}
        derived = {"components", "planned_total_bytes"}
        unknown = sorted(set(obj) - known - derived)
        if unknown:
            raise ValueError(f"unknown DeploymentPlan fields {unknown}; "
                             f"known: {sorted(known)}")
        kw = {k: v for k, v in obj.items() if k in known}
        kw["config"] = ServingConfig.from_json(kw["config"])
        kw["programs"] = tuple(ProgramEstimate.from_json(p)
                               for p in kw.get("programs", ()))
        if kw.get("comms") is not None:
            from .comms import CommsBudget

            kw["comms"] = CommsBudget.from_json(kw["comms"])
        return cls(**kw)

    def render_table(self) -> str:
        """The deploy-review artifact ``--hbm`` prints."""
        total = self.planned_total_bytes
        fit = "FIT" if total <= self.usable_bytes else "OVER"
        lines = [
            f"== hbm residency: {self.config.name} ==",
            f"  budget {fmt_bytes(self.budget_bytes):>12s}   headroom "
            f"{self.headroom:.0%}   usable {fmt_bytes(self.usable_bytes)}"
            f"   tp={self.tp}",
        ]
        for comp, nbytes in self.components().items():
            pct = 100.0 * nbytes / self.budget_bytes
            lines.append(f"  {comp:12s} {fmt_bytes(nbytes):>12s}  "
                         f"{pct:5.1f}% of budget")
        lines.append(f"  {'total':12s} {fmt_bytes(total):>12s}  "
                     f"{100.0 * total / self.budget_bytes:5.1f}% -> {fit}")
        if self.comms is not None:
            share = self.comms.share_of_tick()
            wall_ms = self.comms.tick_wall_s * 1e3
            lines.append(
                f"  {'comms':12s} {fmt_bytes(self.comms.bytes_per_tick):>12s}"
                + ("  on wire/tick, interconnect unknown (un-gated)"
                   if share is None else
                   f"  on wire/tick = {share:6.1%} of the {wall_ms:.0f}ms "
                   "tick wall"))
        for p in self.programs:
            measured = (fmt_bytes(p.measured_peak_bytes)
                        if p.measured_peak_bytes else "n/a")
            lines.append(f"  program {p.name}: static peak "
                         f"{fmt_bytes(p.peak_bytes)} (temps "
                         f"{fmt_bytes(p.temp_bytes)}), measured {measured}")
        return "\n".join(lines)


# ================================================================ the rules
def _rule_over_budget(plan):
    total, usable = plan.planned_total_bytes, plan.usable_bytes
    if total <= usable:
        return
    comps = ", ".join(f"{k}={fmt_bytes(v)}"
                      for k, v in plan.components().items())
    yield Finding(
        "hbm-over-budget", HIGH,
        f"planned residency {fmt_bytes(total)} exceeds the usable budget "
        f"{fmt_bytes(usable)} ({fmt_bytes(plan.budget_bytes)} x "
        f"(1 - {plan.headroom:.0%}) headroom): {comps}",
        subject=f"{plan.config.name}:plan",
        remediation="shrink the pool (plan_kv_pool sizes it to fit), raise "
                    "tp, narrow the KV dtype, or declare a bigger card")


def _rule_estimate_drift(plan, rel_tol=DRIFT_REL_TOL,
                         abs_floor=DRIFT_ABS_FLOOR):
    for p in plan.programs:
        real = p.measured_peak_bytes
        if not real:
            continue                    # no measurement here: ungated
        static = int(p.peak_bytes)
        real = int(real)
        lo = real / (1.0 + rel_tol)
        hi = real * (1.0 + rel_tol)
        if lo <= static <= hi or abs(static - real) <= abs_floor:
            continue
        yield Finding(
            "estimate-drift", HIGH,
            f"program {p.name!r}: static peak {fmt_bytes(static)} vs "
            f"measured peak {fmt_bytes(real)} — outside the "
            f"{rel_tol:+.0%} tolerance; the estimator (or this trace) is "
            "lying and every residency number downstream is suspect",
            subject=f"{plan.config.name}:{p.name}",
            remediation="re-derive the program estimate from the deployed "
                        "trace, or fix analysis/hbm.py estimate_peak")


def _rule_oversized_temp(plan, strict=False):
    sev = HIGH if strict else WARN
    cap = int(OVERSIZED_TEMP_FRACTION * plan.budget_bytes)
    for p in plan.programs:
        if p.largest_bytes <= cap:
            continue
        yield Finding(
            "oversized-temp", sev,
            f"program {p.name!r} materializes a single "
            f"{fmt_bytes(p.largest_bytes)} buffer ({p.largest_label}) at "
            f"its peak — over {OVERSIZED_TEMP_FRACTION:.0%} of the "
            f"{fmt_bytes(plan.budget_bytes)} budget",
            where=p.largest_where,
            subject=f"{plan.config.name}:{p.name}",
            remediation="chunk or recompute the producing op (a broadcast "
                        "this size usually wants to be tiled)")


def _rule_pool_misfit(plan, strict=False):
    sev = HIGH if strict else WARN
    cfg = plan.config
    live_blocks = plan.num_blocks - plan.prefix_blocks
    if cfg.max_seq_len:
        need = cfg.slots * blocks_for(cfg.max_seq_len, cfg.block_size)
        if need > live_blocks:
            yield Finding(
                "pool-misfit", sev,
                f"{cfg.slots} slots x blocks_for({cfg.max_seq_len}) = "
                f"{need} blocks exceed the {live_blocks} live pool blocks "
                f"({plan.num_blocks} - {plan.prefix_blocks} parked) — full "
                "concurrency at max length queues on blocks",
                subject=f"{cfg.name}:pool",
                remediation="grow num_blocks, shrink max_seq_len/slots, or "
                            "accept admission-time deferrals")
            return
    reachable = cfg.slots * cfg.table_width + plan.prefix_blocks
    unreachable = max(0, plan.num_blocks - reachable)
    if unreachable > POOL_WASTE_FRACTION * plan.num_blocks:
        yield Finding(
            "pool-misfit", sev,
            f"{unreachable} of {plan.num_blocks} pool blocks "
            f"({unreachable / plan.num_blocks:.0%}) are unreachable by any "
            f"admissible request ({cfg.slots} slots x table_width "
            f"{cfg.table_width} + {plan.prefix_blocks} parked) — memory "
            "bought, never used",
            subject=f"{cfg.name}:pool",
            remediation="shrink num_blocks (plan_kv_pool clamps to the "
                        "reachable set), raise slots/max_seq_len, or park "
                        "the excess as prefix tier")


def analyze_hbm_plan(plan, *, strict=False, allowlist=None,
                     name=None) -> Report:
    """Run the four residency rules over one DeploymentPlan; a plan that
    carries its interconnect component (``comms``) gets the comms budget
    rule too — the deploy review reads one table."""
    findings = []
    findings.extend(_rule_over_budget(plan))
    findings.extend(_rule_estimate_drift(plan))
    findings.extend(_rule_oversized_temp(plan, strict=strict))
    findings.extend(_rule_pool_misfit(plan, strict=strict))
    rules = tuple(HBM_RULES)
    if plan.comms is not None:
        from .comms import _rule_comms_over_budget

        findings.extend(_rule_comms_over_budget(
            plan.comms, subject=f"{plan.config.name}:comms"))
        rules += ("comms-over-budget",)
    al = allowlist if allowlist is not None else BUILTIN_HBM_ALLOWLIST
    kept, suppressed = al.apply(findings, "")
    return Report(name or f"hbm.residency[{plan.config.name}]", kept,
                  suppressed, rules)


# ============================================================= runtime half
def params_bytes_of(model) -> int:
    """Resident bytes of a model's parameters (the optimizer-free serving
    state), each storage counted once."""
    seen, total = set(), 0
    for p in model.parameters():
        t = getattr(p, "_value", p)
        key = (t.data_ptr(), t.numel(), t.dtype) if t.numel() else id(t)
        if key in seen:
            continue
        seen.add(key)
        total += int(t.numel()) * t.element_size()
    return total


def plan_kv_pool(budget_bytes, *, num_layers, num_kv_heads, head_dim,
                 block_size, dtype="torch.bfloat16", slots=8,
                 max_seq_len=None, params_bytes=0, tp=1,
                 headroom=DEFAULT_HEADROOM, prefix_blocks=0, temps_bytes=0,
                 adapter_bank_bytes=0, name="planned", prefill_chunk=16,
                 decode_steps=4, spec_k=0, eos_token_id=None,
                 decode_kernel="kernel") -> dict:
    """Size a PagedKVCache pool from a device-memory budget: what the
    continuous scheduler's ``hbm_budget=`` consults before building its
    pool. Returns ``{"num_blocks", "fit_blocks", "target_blocks",
    "per_block_bytes", "plan"}``.

    num_blocks = min(the live blocks that fit the usable budget after
    params / tp, temps, adapter banks and the pool's scratch page, what
    the admissible requests can reach: slots x blocks_for(max_seq_len) +
    parked prefix blocks). ``params_bytes`` is the whole replica's (the
    plan divides it by ``tp``)."""
    from .compilesurface import ServingConfig

    budget_bytes = int(budget_bytes)
    usable = int(budget_bytes * (1.0 - headroom))
    fixed = (int(params_bytes) // max(1, int(tp)) + int(temps_bytes)
             + int(adapter_bank_bytes))
    dtype = str(dtype)      # the pool's signature spells it as given
    sig = (int(num_layers), int(num_kv_heads), int(head_dim),
           int(block_size), 0, dtype)
    pbb = per_block_bytes(sig, tp=tp)
    fit = (usable - fixed) // pbb - 1        # the scratch page first
    target = None
    if max_seq_len:
        target = (int(slots) * blocks_for(max_seq_len, block_size)
                  + int(prefix_blocks))
    num_blocks = int(min(fit, target) if target is not None else fit)
    floor = blocks_for(max_seq_len, block_size) if max_seq_len else 1
    if num_blocks < floor:
        raise ValueError(
            f"hbm budget {fmt_bytes(budget_bytes)} cannot fit a KV pool: "
            f"{fmt_bytes(max(0, usable - fixed))} left after params/temps "
            f"buys {max(0, fit)} blocks of {fmt_bytes(pbb)} (and the "
            f"scratch page), need at least {floor}")
    config = ServingConfig(
        name=name, slots=int(slots), prefill_chunk=int(prefill_chunk),
        decode_steps=int(decode_steps), spec_k=int(spec_k),
        eos_token_id=eos_token_id, max_seq_len=max_seq_len,
        kv_signature=(int(num_layers), int(num_kv_heads), int(head_dim),
                      int(block_size), num_blocks, dtype),
        decode_kernel=decode_kernel)
    plan = DeploymentPlan(
        config=config, budget_bytes=budget_bytes, headroom=headroom,
        params_bytes=int(params_bytes), tp=int(tp),
        prefix_blocks=int(prefix_blocks), temps_bytes=int(temps_bytes),
        adapter_bank_bytes=int(adapter_bank_bytes))
    return {"num_blocks": num_blocks, "fit_blocks": int(fit),
            "target_blocks": target, "per_block_bytes": pbb, "plan": plan}


# ============================================================ zoo residency
# The smoke residency the self-check gates on: the zoo GPT's two default
# step programs against the zoo smoke pool and a 64 MiB budget;
# max_seq_len=2048 makes the pool exactly reachable: 8 slots x
# blocks_for(2048) = 128 blocks = the pool.
SMOKE_BUDGET_BYTES = 64 << 20
SMOKE_MAX_SEQ_LEN = 2048


def smoke_budget_bytes() -> int:
    return SMOKE_BUDGET_BYTES


def _idle_launch(model, kv, config, path):
    """Run one step program of ``config``'s geometry once with every slot
    idle (writes go to the scratch page only, as ``inference.warmup``
    launches them) and return its runner."""
    import numpy as np

    S, C, T = config.slots, config.prefill_chunk, config.decode_steps
    W = config.table_width
    tbl = np.zeros((S, W), np.int32)
    zeros = np.zeros((S,), np.int64)
    idle = np.zeros((S,), bool)
    kern = config.decode_kernel
    if path == "prefill_chunk":
        model.prefill_chunk(np.zeros((S, C), np.int64), zeros, zeros, kv,
                            tbl, eos_token_id=config.eos_token_id,
                            decode_kernel=kern)
        return model.compiled_prefill_chunk_runner(S, C)
    if path == "decode_step":
        model.decode_step(zeros, zeros, idle, kv, tbl, steps=T,
                          max_lens=zeros, eos_token_id=config.eos_token_id,
                          decode_kernel=kern)
        return model.compiled_decode_step_runner(S, T)
    if path == "verify_step":
        model.verify_step(np.zeros((S, config.spec_k + 1), np.int64), zeros,
                          zeros, idle, kv, tbl, max_lens=zeros,
                          decode_kernel=kern)
        return model.compiled_verify_step_runner(S, config.spec_k + 1)
    raise ValueError(f"no residency trace for path {path!r}")


def program_estimate(model, kv, config, path, with_measured=True):
    """(ProgramEstimate, PeakEstimate) of one step program of ``config``:
    the static estimate of its traced graph and, on the card, its measured
    body peak."""
    from .core import trace_runner

    run = _idle_launch(model, kv, config, path)
    gm, labels = trace_runner(model, run)
    est = estimate_peak(gm, arg_names=labels, name=path)
    real = (measure_body_peak(run, argument_bytes=est.argument_bytes)
            if with_measured else None)
    return ProgramEstimate.from_estimate(est, measured=real), est


def smoke_plan(*, budget_bytes=None, with_measured=True, config_name=None,
               device=None):
    """The zoo residency plan: smoke GPT + smoke pool + the default
    continuous paths, statically estimated and, on the card, measured.
    ``config_name`` picks one of the shipped serving configs."""
    import dataclasses as _dc

    from ..inference.kv_cache import PagedKVCache
    from .compilesurface import default_serving_configs
    from .zoo import _gpt_smoke

    _cfg, model = _gpt_smoke(device)
    model.eval()
    shipped = default_serving_configs()
    if config_name is None:
        base = shipped[0]
    else:
        match = [c for c in shipped if c.name == config_name]
        if not match:
            raise ValueError(f"unknown serving config {config_name!r}; "
                             f"shipped: {[c.name for c in shipped]}")
        base = match[0]
    layers, kv_heads, head_dim, block_size, num_blocks, dtype = \
        base.kv_signature[:6]
    kv = PagedKVCache(layers, kv_heads, head_dim, block_size=block_size,
                      num_blocks=num_blocks, dtype=dtype.replace("torch.", ""),
                      device=model.device)
    config = _dc.replace(base, name="hbm-smoke",
                         max_seq_len=SMOKE_MAX_SEQ_LEN,
                         kv_signature=kv.signature())
    programs = tuple(program_estimate(model, kv, config, path,
                                      with_measured)[0]
                     for path in config.active_paths())
    return DeploymentPlan(
        config=config,
        budget_bytes=int(budget_bytes or SMOKE_BUDGET_BYTES),
        params_bytes=params_bytes_of(model),
        programs=programs)


def analyze_hbm_residency(allowlist=None, *, budget_bytes=None,
                          name="hbm.residency", device=None) -> Report:
    """The ``hbm_residency`` zoo entry body: smoke plan -> the four
    rules."""
    plan = smoke_plan(budget_bytes=budget_bytes, device=device)
    return analyze_hbm_plan(plan, allowlist=allowlist, name=name)


# ------------------------------------------------------------- fixture mode
def hbm_fixture_reports(path):
    """Seeded-violation mode for ``--hbm PATH``: a ``.json`` file is a
    DeploymentPlan spec (``{"plan": {...}}`` or the plan itself); a ``.py``
    file defines ``make_program()`` -> ``(fn, args)`` and ``BUDGET_BYTES``
    and is traced and estimated against that budget. Directories run every
    fixture inside. Everything is strict with an empty allowlist."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.endswith((".py", ".json")))
        out = []
        for n in names:
            out.extend(hbm_fixture_reports(os.path.join(path, n)))
        return out
    label = f"hbm[{os.path.basename(path)}]"
    if path.endswith(".json"):
        with open(path, "r") as fh:
            spec = json.load(fh)
        plan = DeploymentPlan.from_json(spec.get("plan", spec))
        return [analyze_hbm_plan(plan, strict=True, allowlist=Allowlist([]),
                                 name=label)]
    import runpy

    from .compilesurface import ServingConfig

    mod = runpy.run_path(path)
    if "make_program" not in mod or "BUDGET_BYTES" not in mod:
        raise ValueError(f"{path}: a .py hbm fixture must define "
                         "make_program() -> (fn, args) and BUDGET_BYTES")
    fn, args = mod["make_program"]()
    est = estimate_peak(trace(fn, *args), name=os.path.basename(path))
    budget = int(mod["BUDGET_BYTES"])
    config = ServingConfig(name=os.path.basename(path), slots=1,
                           max_seq_len=1,
                           kv_signature=(1, 1, 1, 1, 1, "torch.bfloat16"))
    plan = DeploymentPlan(
        config=config, budget_bytes=budget,
        programs=(ProgramEstimate.from_estimate(est),))
    return [analyze_hbm_plan(plan, strict=True, allowlist=Allowlist([]),
                             name=label)]
