"""Sharding & collective lint — the counterpart of
``paddle_tpu/analysis/comms.py``, with its five rules, their ids and
severities, its ring formulas, its budget and its JSON shapes.

The port's tensor-parallel step programs call their collectives
explicitly (``distributed/collective.py`` ``_all_reduce_`` under the
row-parallel and vocab-parallel layers, ``_gather_cat`` for the sampled
logits) and run as CUDA graphs, which hold no program text. So where JAX
reads the post-SPMD compiled HLO, this pass reads the FX graph that
``analysis.core.trace_runner`` traces over fake tensors: every c10d
operator (``allreduce_``, ``allgather_`` / ``_allgather_base_``,
``reduce_scatter_`` / ``_reduce_scatter_base_``, ``alltoall_base_``,
``send``, and the ``_c10d_functional`` forms) is one node, recorded under
JAX's kind with the shape and dtype of its buffer, the size of its process
group and the port file and line that called it. Tracing runs nothing on a
device and sends nothing.

Tracing at tp = 2 needs a process group of two ranks. ``tp_world`` makes
one in this process with torch's ``fake`` backend (``FakeStore``, imported
when used) when no default group exists, and destroys it afterwards, so
nothing else in the process sees a group; when a real default group of two
or more ranks exists (the dryrun's gloo ranks), it traces over that one.
The c10d operators have fake kernels: under ``make_fx(tracing_mode="fake")``
they are recorded, not run. The port's ``decode_step`` unrolls its steps in
Python, so its trace holds every step's collectives and ``loop_steps`` is
1: its totals are JAX's scan count times the steps.

Two halves, five rules:

* **Collective inventory** — rules ``implicit-reshard`` (HIGH: a collective
  kind no declared ``SpecLayout`` transition explains) and
  ``comms-over-budget`` (HIGH: per-tick wire bytes against the card's
  NVLink, ``observability.device.device_interconnect_bandwidth``; silent
  off the table, as JAX's is off the TPU).
* **Layout contract** — each input's partition entries come from where the
  port says its part sits (``distributed/layout.layout_of`` for the
  parameters, the pools' kv-head axis), under JAX's argument labels
  (``models/generation.py`` ``STEP_ARG_LABELS``). Rules
  ``layout-contract-drift`` (HIGH) against ``SpecLayout.step_contract()``
  and JAX's declared output layouts, ``replicated-large-buffer`` (WARN,
  strict HIGH) and ``dead-mesh-axis`` (WARN; ``dp``, the replica-fleet
  axis, trips it by design and is allowlisted with its reason).

Gating: the ``comms_surface`` zoo entry (``--self-check``), the CLI
``--comms [NAME|PATH]`` (the per-program collective table; PATH = strict
fixture mode over ``tests/torch_analysis_fixtures/comms/``) and
``DeploymentPlan.comms`` in the residency plan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import json
import os
import re
import time

import torch

from .core import Report, fmt_bytes, iter_eqns, op_name
from .findings import HIGH, WARN, Allowlist, AllowlistEntry, Finding

__all__ = [
    "COMMS_RULES", "BUILTIN_COMMS_ALLOWLIST", "CollectiveOp",
    "CommsEstimate", "CommsBudget", "collective_inventory", "bytes_on_wire",
    "tp_world", "traced_comms_surface", "step_surface",
    "step_comms_surfaces", "serving_comms_surfaces", "render_comms_table",
    "analyze_comms_surfaces", "analyze_step_comms",
    "sampled_logits_gather_surface", "smoke_comms_budget",
    "comms_fixture_reports", "DEFAULT_TPOT_BUDGET_S",
    "REPLICATED_BUFFER_MIN_BYTES",
]

COMMS_RULES = {
    "implicit-reshard":
        "a collective in the traced step program that no declared "
        "SpecLayout transition explains — traffic behind the layout "
        "contract's back, paid on every launch",
    "layout-contract-drift":
        "an input/output layout disagrees with the declared SpecLayout "
        "contract entry that names it (or a contract glob matches nothing "
        "— the contract rotted off the program)",
    "comms-over-budget":
        "per-tick collective bytes-on-wire cannot cross the card's NVLink "
        "inside the tick wall budget at the configured tp (silent when the "
        "interconnect is unknown, e.g. CPU)",
    "replicated-large-buffer":
        "a >=1 MiB program input is fully replicated over tp though a mesh "
        "axis could shard one of its dimensions (HIGH in strict mode; the "
        "LoRA adapter bank is the known candidate)",
    "dead-mesh-axis":
        "a declared mesh axis that no input/output layout in the program "
        "set uses — topology bought, never wired",
}

# tick wall budget: decode_steps tokens per tick, each owed the default
# p99 TPOT objective shipped in observability/slo.py (tpot_p99_ms: 50)
DEFAULT_TPOT_BUDGET_S = 0.050
REPLICATED_BUFFER_MIN_BYTES = 1 << 20

_STEP_PATHS = ("prefill_chunk", "decode_step", "verify_step")

# ========================================================== buffer types
# A collective's buffer is printed as JAX prints an HLO type, ``bf16[2,8,64]``,
# so the JSON fixtures (written in that syntax) and the table read alike.
_HLO_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}
_HLO_TYPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_TORCH_DTYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


def _hlo_result_bytes(result: str):
    """(dtype, bytes) of a printed buffer type — tuple types sum their
    elements and report the first element's dtype."""
    total, dtype = 0, ""
    for dt, dims in _HLO_TYPE_RE.findall(result):
        if dt not in _HLO_DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _HLO_DTYPE_BYTES[dt]
        dtype = dtype or dt
    return dtype, total


def _type_str(t) -> str:
    dt = _TORCH_DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{dt}[{','.join(str(int(s)) for s in t.shape)}]"


def bytes_on_wire(kind, buffer_bytes, group_size) -> int:
    """Bytes one participating card puts on the interconnect per execution
    of one collective, ring algorithms (JAX's formulas):

    * all-gather (buffer = the full gathered buffer G):       G(n-1)/n
    * all-reduce (buffer = the full buffer B):               2B(n-1)/n
    * reduce-scatter (buffer = the scattered shard Bs):       Bs(n-1)
    * all-to-all (buffer = the per-card buffer B):            B(n-1)/n
    * collective-permute:                                     B
    """
    n = max(1, int(group_size))
    b = int(buffer_bytes)
    if kind == "all-reduce":
        return 2 * b * (n - 1) // n
    if kind == "reduce-scatter":
        return b * (n - 1)
    if kind == "collective-permute":
        return b
    return b * (n - 1) // n            # all-gather / all-to-all / others


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in a traced program: what crosses cards, how big,
    how often per launch, and which source line put it there."""
    kind: str
    result: str                  # the buffer's type, per card
    dtype: str
    buffer_bytes: int
    group_size: int
    count: int                   # executions per program launch
    wire_bytes: int              # bytes-on-wire per launch (count folded in)
    op_name: str = ""
    where: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ==================================================== the FX inventory
# c10d operator -> (JAX's kind, the schema argument holding the buffer
# bytes_on_wire's formula reads; None: the node's own value). Any other
# collective a trace holds is inventoried under its own operator name,
# which no layout declares: implicit-reshard reports it.
_KINDS = {
    "c10d.allreduce_": ("all-reduce", "tensors"),
    "c10d.allreduce_coalesced_": ("all-reduce", "tensors"),
    "c10d.allgather_": ("all-gather", "output_tensors"),
    "c10d._allgather_base_": ("all-gather", "output_tensor"),
    "c10d.reduce_scatter_": ("reduce-scatter", "output_tensors"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "output_tensor"),
    "c10d.alltoall_base_": ("all-to-all", "output"),
    "c10d.alltoall_": ("all-to-all", "output_tensors"),
    "_c10d_functional.all_reduce": ("all-reduce", "input"),
    "_c10d_functional.all_reduce_": ("all-reduce", "input"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None),
    "_c10d_functional.all_to_all_single": ("all-to-all", None),
}
# c10d operators that move no tensor between ranks, or only complete one
_NOT_COLLECTIVES = ("wait_tensor", "barrier", "monitored_barrier_",
                    "check_for_nan", "_wrap_tensor_autograd")
# the collective plumbing: a node's provenance is the first frame outside it
_PLUMBING = ("distributed/collective.py", "distributed/fleet/mp_ops.py")
_FRAME_RE = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _arg(node, name):
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return None
    for i, a in enumerate(schema.arguments):
        if a.name == name:
            if not a.kwarg_only and i < len(node.args):
                return node.args[i]
            return node.kwargs.get(name)
    return None


def _fake_tensors(v):
    """The tensors a node argument (a Node, or nested lists of them)
    stands for."""
    if isinstance(v, torch.fx.Node):
        v = v.meta.get("val")
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _fake_tensors(x)]
    return []


def _group_size(node) -> int:
    size = _arg(node, "group_size")
    if isinstance(size, int):
        return size
    pg = _arg(node, "process_group")
    if isinstance(pg, torch.fx.Node) and pg.op == "get_attr":
        obj = getattr(pg.graph.owning_module, str(pg.target), None)
        try:
            return int(torch._C._distributed_c10d.ProcessGroup.unbox(
                obj).size())
        except Exception:
            pass
    name = _arg(node, "group_name")
    if isinstance(name, str):
        try:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group,
            )

            return int(_resolve_process_group(name).size())
        except Exception:
            pass
    return 1


def _where(node) -> str:
    """The innermost port frame outside the collective plumbing (else the
    innermost frame), as ``paddle_tpu_torch/<path>:<line> (<function>)``."""
    frames = []
    for path, line, fn in _FRAME_RE.findall(
            node.meta.get("stack_trace") or ""):
        p = path.replace(os.sep, "/")
        i = p.rfind("paddle_tpu_torch/")
        frames.append((p[i:] if i >= 0 else p, line, fn, i >= 0))
    ours = [f for f in frames if f[3] and not f[0].endswith(_PLUMBING)]
    best = (ours or frames or [None])[-1]
    if best is None:
        stack = node.meta.get("nn_module_stack")
        return (f"module {list(stack.values())[-1][0]}" if stack
                else op_name(node))
    return f"{best[0]}:{best[1]} ({best[2]})"


def collective_inventory(gm):
    """Every collective node of a traced ``GraphModule`` (sub-graphs too),
    in graph order, each run once per launch: the port's step programs
    unroll their loops into the trace, so no op is multiplied by a loop
    count as JAX's scanned ones are."""
    ops = []
    for node, _stack, _scope in iter_eqns(gm):
        name = op_name(node)
        if not name.startswith(("c10d.", "_c10d_functional.")) \
                or name.endswith(_NOT_COLLECTIVES):
            continue
        kind, arg = _KINDS.get(name, (name, None))
        tensors = _fake_tensors(node if arg is None else _arg(node, arg))
        if not tensors and name not in _KINDS:
            tensors = _fake_tensors(list(node.args))
        if not tensors:
            continue
        nbytes = sum(int(t.numel()) * t.element_size() for t in tensors)
        result = (_type_str(tensors[0]) if len(tensors) == 1 else
                  "(" + ", ".join(_type_str(t) for t in tensors) + ")")
        dtype = _TORCH_DTYPES.get(tensors[0].dtype, str(tensors[0].dtype))
        group = _group_size(node)
        ops.append(CollectiveOp(
            kind=kind, result=result, dtype=dtype, buffer_bytes=nbytes,
            group_size=group, count=1,
            wire_bytes=bytes_on_wire(kind, nbytes, group),
            op_name=name, where=_where(node)))
    return ops


# ======================================================== layout labels
def _normalize_spec(entries) -> tuple:
    """A partition spec as a canonical tuple: sub-tuples kept, trailing
    Nones dropped (``('tp',)`` and ``('tp', None)`` are one placement)."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e
           for e in (entries or ())]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _spec_from_layout(t, axis="tp") -> tuple:
    """Partition entries of a parameter from where its part sits: each
    dimension whose part is narrower than the whole is cut over ``axis``."""
    from ..distributed.layout import layout_of

    whole, _pieces = layout_of(t)
    return _normalize_spec([axis if int(s) != int(g) else None
                            for s, g in zip(t.shape, whole)])


_PATH_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _label_parts(label):
    head = label.split("[", 1)[0]
    return [head] + [a if a else int(b) for a, b in _PATH_RE.findall(label)]


def traced_comms_surface(gm, *, name, input_specs=None, input_bytes=None,
                         output_specs=None, mesh_axes=None,
                         device="") -> dict:
    """The comms view of one traced program: its collective inventory and
    the labelled input / output layouts the caller read off the port
    (``loop_steps`` 1: see ``collective_inventory``)."""
    ops = collective_inventory(gm)
    return {
        "name": name,
        "mesh_axes": dict(mesh_axes or {}),
        "loop_steps": 1,
        "ops": ops,
        "bytes_per_launch": sum(op.wire_bytes for op in ops),
        "input_specs": dict(input_specs or {}),
        "input_bytes": dict(input_bytes or {}),
        "output_specs": dict(output_specs or {}),
        "device": device,
    }


def step_surface(model, kv, run, path, *, name, mesh_axes,
                 stack_traces=True) -> dict:
    """The comms surface of one step program runner (built by
    ``models/generation.py`` over ``kv``): its FX graph's collectives, and
    its inputs and outputs under JAX's labels — ``state.<param>`` (the
    parameter's layout), ``k_pages.<layer>`` / ``v_pages.<layer>`` (the
    kv-head axis when the pool is head-sharded), the runner inputs
    (``STEP_INPUT_LABELS``) replicated; ``out.<i>`` the sampled results
    (replicated) and then the pools the program writes in place.
    ``stack_traces=False``: each collective's ``where`` is its operator
    (the trace takes about a third less time)."""
    from ..distributed.layout import layout_of
    from ..models.generation import STEP_INPUT_LABELS
    from .core import trace_runner

    t0 = time.perf_counter()
    gm, labels = trace_runner(model, run, stack_traces=stack_traces)
    trace_s = time.perf_counter() - t0
    params = dict(model._decode_layer().named_parameters())
    pool = ("tp",) if kv.tp_sharded else ()
    names = STEP_INPUT_LABELS[path]
    vals = [n.meta.get("val") for n in gm.graph.nodes
            if n.op == "placeholder"]
    in_specs, in_bytes = {}, {}

    def put(label, spec, t, whole=None):
        in_specs[label] = spec
        shape = tuple(int(s) for s in (whole or t.shape))
        nbytes = int(torch.Size(shape).numel()) * t.element_size()
        if label in in_bytes:       # two runner inputs, one JAX label
            nbytes += in_bytes[label]["bytes"]
        in_bytes[label] = {"bytes": nbytes, "shape": shape}

    for label, t in zip(labels, vals):
        parts = _label_parts(label)
        if not isinstance(t, torch.Tensor):
            continue
        if parts[:2] == ["closed", "state"]:
            p = params.get(parts[2])
            if p is None:
                continue
            put(f"state.{parts[2]}", _spec_from_layout(p),
                t, layout_of(p)[0])
        elif parts[0] == "closed" and parts[1] in ("k_pages", "v_pages"):
            whole = (kv.num_kv_heads,) + tuple(t.shape[1:])
            put(f"{parts[1]}.{parts[2]}", pool, t, whole)
        elif parts[:2] == ["closed", "bank"]:
            put("bank", (), t)
        elif parts[0] == "inputs" and parts[1] in names:
            put(names[parts[1]], (), t)
    out_specs = {}
    outs = list(run.outputs.dev)
    for i, _name in enumerate(outs):
        out_specs[f"out.{i}"] = ()
    for j in range(kv.num_layers):
        out_specs[f"out.{len(outs)}.{j}"] = pool
        out_specs[f"out.{len(outs) + 1}.{j}"] = pool
    tp = 1 if not kv.tp_sharded else kv.tp
    s = traced_comms_surface(gm, name=name, input_specs=in_specs,
                             input_bytes=in_bytes, output_specs=out_specs,
                             mesh_axes=mesh_axes, device=model.device.type)
    s["path"] = path
    s["tp"] = tp
    s["trace_s"] = trace_s
    # the port's kernel operators the trace holds (torch.library nodes)
    kernels: dict = {}
    for node, _stack, _scope in iter_eqns(gm):
        name = op_name(node)
        if name.startswith("paddle_tpu_torch."):
            kernels[name] = kernels.get(name, 0) + 1
    s["kernel_nodes"] = kernels
    # the decode program's steps per launch (its [slots, steps] tokens):
    # the tick the budget's wall is counted in
    s["decode_steps"] = (int(run.outputs.dev["tokens"].shape[1])
                         if path == "decode_step" else 1)
    return s


# ============================================================ the tp world
@contextlib.contextmanager
def tp_world(tp=2):
    """Within: a process group of ``tp`` or more ranks and the ("dp",
    "tp") serving mesh at ``tp`` installed as the global mesh; yields the
    mesh's axis sizes. With no default process group, a ``fake`` one of
    ``tp`` ranks is made (rank 0; torch's ``FakeStore``: nothing is sent)
    and destroyed on the way out, with every group made over it; a real
    default group of W >= ``tp`` ranks (W a multiple of ``tp``) is used as
    it is, under ``serving_mesh(dp=W // tp, tp=tp)`` — every rank of it
    must enter together, since making the mesh's groups is collective.
    The previous global mesh comes back after."""
    import torch.distributed as dist

    from ..distributed import collective
    from ..distributed.mesh import get_mesh, serving_mesh, set_mesh

    tp = int(tp)
    prev = get_mesh()
    made = not dist.is_initialized()
    if made:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=tp)
    try:
        world = dist.get_world_size()
        if world < tp or world % tp:
            raise ValueError(f"tp={tp} over a process group of {world} "
                             "ranks: it needs a multiple of tp")
        serving_mesh(dp=world // tp, tp=tp)
        yield {"dp": world // tp, "tp": tp}
    finally:
        set_mesh(prev)
        if made:
            collective._DEFAULT["group"] = None
            dist.destroy_process_group()


# ============================================================ the step zoo
def _build_step_program(path, device=None):
    """One continuous-scheduler step program at the zoo's smoke geometry
    under the CURRENT mesh (JAX ``comms.py:325-372``): the smoke GPT, its
    pool, one slot live and one idle; the step calls JAX's construction
    makes build the runner and run nothing (``_runners_only``). Returns
    (model, kv, runner, name)."""
    import numpy as np

    from .zoo import _continuous_smoke

    model, kv, tbl, ids, S, C, NEW, T = _continuous_smoke(device)
    lens0 = np.asarray([C, 0], np.int64)
    act = np.asarray([True, False])
    lmax = np.asarray([C + NEW, 0], np.int64)
    with _runners_only(model):
        if path == "prefill_chunk":
            model.prefill_chunk(ids, np.zeros(S, np.int64), lens0, kv, tbl)
            return (model, kv, model.compiled_prefill_chunk_runner(S, C),
                    "gpt.decode.paged_prefill_chunk_tp")
        if path == "decode_step":
            model.decode_step(np.zeros(S, np.int64), lens0, act, kv, tbl,
                              steps=T, max_lens=lmax)
            return (model, kv, model.compiled_decode_step_runner(S, T),
                    "gpt.decode.paged_step_tp")
        if path == "verify_step":
            K = 3
            chunk = np.zeros((S, K + 1), np.int64)
            chunk[0] = np.random.RandomState(1).randint(0, 512, K + 1)
            model.verify_step(chunk, lens0, np.asarray([K, 0], np.int64),
                              act, kv, tbl, max_lens=lmax)
            return (model, kv, model.compiled_verify_step_runner(S, K + 1),
                    "gpt.decode.paged_verify_step_tp")
    raise ValueError(f"no comms surface for step path {path!r}")


def step_comms_surfaces(paths=None, *, device=None):
    """The zoo's step programs traced at tp 2 inside ``tp_world`` and
    their comms surfaces (JAX ``step_comms_surfaces``)."""
    surfaces = []
    with tp_world(2) as axes:
        for path in paths or _STEP_PATHS:
            model, kv, run, name = _build_step_program(path, device)
            surfaces.append(step_surface(model, kv, run, path, name=name,
                                         mesh_axes=axes))
    return surfaces


@contextlib.contextmanager
def _runners_only(model):
    """Within: a step call of ``model`` builds (or fetches) its runner and
    returns the runner's output buffers without running the program —
    the runner is all a trace needs, and nothing is launched."""
    model._run_step = lambda run, *_args: run.read()
    try:
        yield
    finally:
        del model._run_step


def serving_comms_surfaces(model, kv, config, *, mesh_axes,
                           stack_traces=True):
    """Comms surfaces of a serving configuration's step programs over a
    model and pool built under the current mesh (``tp_world``'s axes):
    each program's runner built by a step call with every slot idle
    (``hbm._idle_launch``'s arguments) that runs nothing, then traced
    (``stack_traces`` as ``step_surface``'s)."""
    from .hbm import _idle_launch

    names = {"prefill_chunk": "paged_prefill_chunk",
             "decode_step": "paged_step", "verify_step": "paged_verify_step"}
    out = []
    for path in config.active_paths():
        with _runners_only(model):
            run = _idle_launch(model, kv, config, path)
        out.append(step_surface(model, kv, run, path,
                                name=f"gpt.decode.{names[path]}_tp",
                                mesh_axes=mesh_axes,
                                stack_traces=stack_traces))
    return out


# declared OUTPUT layout per step path (JAX ``comms.py:408-415``): the KV
# pool layers stay head-sharded on the way out; sampled tokens come back
# replicated to the host.
_OUTPUT_CONTRACT = {
    "prefill_chunk": {"out.0": (), "out.1.*": ("tp",), "out.2.*": ("tp",)},
    "decode_step": {"out.0": (), "out.1.*": ("tp",), "out.2.*": ("tp",)},
    "verify_step": {"out.0": (), "out.1": (),
                    "out.2.*": ("tp",), "out.3.*": ("tp",)},
}


def render_comms_table(surfaces, grouped=False) -> str:
    """The deploy-review artifact ``--comms`` prints: one row per
    collective with its wire cost, per program. ``grouped``: identical
    rows (kind, buffer, group, call site) merged into one with their
    count, for a program at full depth."""
    lines = []
    for s in surfaces:
        tp = s.get("tp") or s.get("mesh_axes", {}).get("tp", "?")
        lines.append(f"== comms surface: {s['name']} (tp={tp}) ==")
        if not s["ops"]:
            lines.append("  no collectives")
        rows: dict = {}
        for op in s["ops"]:
            key = ((op.kind, op.result, op.group_size, op.where) if grouped
                   else id(op))
            n, wire, first = rows.get(key, (0, 0, op))
            rows[key] = (n + op.count, wire + op.wire_bytes, first)
        for n, wire, op in rows.values():
            lines.append(
                f"  {op.kind:18s} {op.result:22s} group={op.group_size} "
                f"x{n:<3d} {fmt_bytes(wire):>10s} on wire  @ {op.where}")
        lines.append(f"  per-launch total {fmt_bytes(s['bytes_per_launch'])}"
                     " on wire per card")
    return "\n".join(lines)


# ================================================================ the rules
def _rule_implicit_reshard(surface, expected):
    """HIGH: a collective kind no declared layout transition explains."""
    for op in surface["ops"]:
        if op.kind in expected:
            continue
        yield Finding(
            "implicit-reshard", HIGH,
            f"{op.kind} {op.result} (group={op.group_size}, x{op.count} "
            f"per launch, {fmt_bytes(op.wire_bytes)} on wire) has no "
            f"declared layout transition — declared transitions: "
            f"{sorted(expected)}",
            where=op.where, subject=surface["name"],
            remediation="cut the tensor along the axis its consumer reads "
                        "it on, declare the transition in "
                        "SpecLayout.expected_collectives, or allowlist it "
                        "with the reason")


def _rule_layout_contract(surface, contract):
    """HIGH: an input or output layout disagrees with the contract."""
    actual = {}
    actual.update(surface.get("input_specs", {}))
    actual.update(surface.get("output_specs", {}))
    if not contract or not actual:
        return
    for glob, want in sorted(contract.items()):
        want_n = _normalize_spec(want)
        hits = [k for k in actual if fnmatch.fnmatch(k, glob)]
        if not hits:
            yield Finding(
                "layout-contract-drift", HIGH,
                f"contract entry {glob!r} -> {want_n} matches no input or "
                "output of the traced program — the contract rotted off "
                "the argument names",
                subject=surface["name"],
                remediation="re-aim the contract glob at the current "
                            "argument labels (or delete the entry)")
            continue
        for k in hits:
            got = _normalize_spec(actual[k])
            if got != want_n:
                yield Finding(
                    "layout-contract-drift", HIGH,
                    f"{k}: layout {got} != declared {want_n} "
                    f"(contract entry {glob!r})",
                    where=k, subject=surface["name"],
                    remediation="fix the cut at the layer that makes the "
                                "part (distributed/fleet/meta_parallel.py, "
                                "bridge.shard_state) or update the "
                                "contract if the new layout is intended")


def _rule_replicated_large_buffer(surface, strict=False,
                                  min_bytes=REPLICATED_BUFFER_MIN_BYTES):
    """WARN (strict HIGH): a large input replicated over a shardable tp."""
    tp = int(surface.get("tp")
             or surface.get("mesh_axes", {}).get("tp", 1))
    if tp <= 1:
        return
    sev = HIGH if strict else WARN
    specs = surface.get("input_specs", {})
    for label, meta in sorted(surface.get("input_bytes", {}).items()):
        nbytes, shape = meta["bytes"], meta["shape"]
        if nbytes < min_bytes or _normalize_spec(specs.get(label)) != ():
            continue
        shardable = [i for i, d in enumerate(shape) if d and d % tp == 0]
        if not shardable:
            continue
        yield Finding(
            "replicated-large-buffer", sev,
            f"{label}: {fmt_bytes(nbytes)} {tuple(shape)} is fully "
            f"replicated over tp={tp} though dim(s) {shardable} divide tp "
            f"— {fmt_bytes(nbytes - nbytes // tp)} of HBM per card bought "
            "back by sharding it",
            where=label, subject=surface["name"],
            remediation="give the buffer a SpecLayout axis (the adapter "
                        "bank shards on its rank or output dim) or record "
                        "here why replication is the better trade")


def _rule_dead_mesh_axis(mesh_axes, surfaces):
    """WARN: a declared axis no layout in the program set uses."""
    if not mesh_axes:
        return
    used = set()
    for s in surfaces:
        for spec in list(s.get("input_specs", {}).values()) \
                + list(s.get("output_specs", {}).values()):
            for e in spec:
                for name in (e if isinstance(e, tuple) else (e,)):
                    if name:
                        used.add(name)
    names = ", ".join(s["name"] for s in surfaces)
    for axis in sorted(mesh_axes):
        if axis in used:
            continue
        yield Finding(
            "dead-mesh-axis", WARN,
            f"declared mesh axis {axis!r} (size {mesh_axes[axis]}) is used "
            f"by no input/output layout across: {names}",
            subject=surfaces[0]["name"] if surfaces else "comms",
            remediation="drop the axis from the mesh, or wire it into a "
                        "SpecLayout placement (an axis that shards nothing "
                        "still fragments the device grid)")


def _rule_comms_over_budget(budget, subject="comms"):
    """HIGH: the tick's wire bytes cannot fit the tick wall at this
    interconnect."""
    if budget is None or budget.ici_bytes_per_s is None:
        return                       # unknown interconnect: ungated, honest
    wire_s = budget.wire_time_s()
    if wire_s <= budget.tick_wall_s:
        return
    per = ", ".join(
        f"{e.name}={fmt_bytes(int(e.bytes_per_launch * e.launches_per_tick))}"
        for e in budget.estimates)
    yield Finding(
        "comms-over-budget", HIGH,
        f"{fmt_bytes(budget.bytes_per_tick)} on wire per tick needs "
        f"{wire_s * 1e3:.2f}ms at {fmt_bytes(int(budget.ici_bytes_per_s))}/s"
        f" per card — over the {budget.tick_wall_s * 1e3:.2f}ms tick wall "
        f"before compute spends a FLOP ({per})",
        subject=subject,
        remediation="raise tp to shrink per-card shards, cut the implicit "
                    "reshards above, or re-plan the tick "
                    "(fewer decode_steps per launch)")


# ====================================================== interconnect budget
@dataclasses.dataclass(frozen=True)
class CommsEstimate:
    """Per-launch wire bytes of one step program, and how often the
    scheduler launches it per tick."""
    name: str
    bytes_per_launch: int
    launches_per_tick: float = 1.0

    def to_json(self) -> dict:
        return {"name": self.name,
                "bytes_per_launch": int(self.bytes_per_launch),
                "launches_per_tick": float(self.launches_per_tick)}

    @classmethod
    def from_json(cls, obj) -> "CommsEstimate":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(f"unknown CommsEstimate fields {unknown}")
        return cls(**obj)


@dataclasses.dataclass(frozen=True)
class CommsBudget:
    """The DeploymentPlan's interconnect component: per-tick collective
    bytes against the card's NVLink and the tick wall. Kept apart from the
    residency components: these are bytes *moved* per tick, not bytes
    *resident*, so they never enter ``components()`` or
    ``planned_total_bytes``. ``ici_bytes_per_s`` keeps JAX's JSON key; it
    holds the one-way NVLink rate here."""
    tick_wall_s: float
    ici_bytes_per_s: float | None = None   # None = unknown (CPU): ungated
    estimates: tuple = ()

    @property
    def bytes_per_tick(self) -> int:
        return int(sum(e.bytes_per_launch * e.launches_per_tick
                       for e in self.estimates))

    def wire_time_s(self) -> float:
        if not self.ici_bytes_per_s:
            return 0.0
        return self.bytes_per_tick / float(self.ici_bytes_per_s)

    def share_of_tick(self):
        """Wire time as a fraction of the tick wall (None when the
        interconnect is unknown)."""
        if self.ici_bytes_per_s is None or not self.tick_wall_s:
            return None
        return self.wire_time_s() / self.tick_wall_s

    def to_json(self) -> dict:
        return {"tick_wall_s": float(self.tick_wall_s),
                "ici_bytes_per_s": self.ici_bytes_per_s,
                "estimates": [e.to_json() for e in self.estimates]}

    @classmethod
    def from_json(cls, obj) -> "CommsBudget":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(f"unknown CommsBudget fields {unknown}")
        kw = dict(obj)
        kw["estimates"] = tuple(CommsEstimate.from_json(e)
                                for e in kw.get("estimates", ()))
        return cls(**kw)


def smoke_comms_budget(surfaces, *, decode_steps=None,
                       ici_bytes_per_s=None) -> CommsBudget:
    """The CommsBudget of a set of surfaces: every step program launches
    once per tick; the tick wall is decode_steps (default: the decode
    program's steps per launch — JAX's scan length) x the default TPOT
    objective; the interconnect is the card's the surfaces were traced
    on, None on the CPU, which un-gates the budget rule rather than
    inventing a number."""
    if ici_bytes_per_s is None:
        from ..observability.device import device_interconnect_bandwidth

        dev = next((s.get("device") for s in surfaces if s.get("device")),
                   "cpu")
        if dev == "cuda":
            dev = f"cuda:{torch.cuda.current_device()}"
        ici_bytes_per_s = device_interconnect_bandwidth(dev)
    steps = decode_steps
    if steps is None:
        steps = max([s.get("decode_steps", s.get("loop_steps", 1))
                     for s in surfaces] or [1])
    return CommsBudget(
        tick_wall_s=steps * DEFAULT_TPOT_BUDGET_S,
        ici_bytes_per_s=ici_bytes_per_s,
        estimates=tuple(CommsEstimate(s["name"], s["bytes_per_launch"])
                        for s in surfaces))


# ============================================================= entry points
def analyze_comms_surfaces(surfaces, *, contract=None, expected=None,
                           mesh_axes=None, budget=None, strict=False,
                           allowlist=None, name="comms.surface") -> Report:
    """Run the five comms rules over a set of surfaces; returns the shared
    Report type (same gating as every other lint leg)."""
    findings = []
    for s in surfaces:
        findings.extend(_rule_implicit_reshard(
            s, expected if expected is not None else default_expected()))
        per_contract = dict(contract or {})
        per_contract.update(s.get("contract", {}))
        if int(s.get("tp") or s.get("mesh_axes", {}).get("tp", 1)) > 1:
            findings.extend(_rule_layout_contract(s, per_contract))
        findings.extend(_rule_replicated_large_buffer(s, strict=strict))
    findings.extend(_rule_dead_mesh_axis(mesh_axes, surfaces))
    findings.extend(_rule_comms_over_budget(
        budget, subject=surfaces[0]["name"] if surfaces else "comms"))
    al = allowlist if allowlist is not None else BUILTIN_COMMS_ALLOWLIST
    device = next((s.get("device") for s in surfaces if s.get("device")), "")
    kept, suppressed = al.apply(findings, device)
    return Report(name, kept, suppressed, tuple(COMMS_RULES))


def default_expected() -> dict:
    from ..distributed.mesh import SpecLayout

    return SpecLayout().expected_collectives()


def analyze_step_comms(allowlist=None, *, paths=None, name="comms.surface",
                       device=None, _surfaces=None) -> Report:
    """The ``comms_surface`` zoo entry body: trace the serving step
    programs at tp = 2, inventory their collectives, check the SpecLayout
    contract, and run all five rules. ``--self-check`` fails on any
    un-allowlisted HIGH here. ``_surfaces`` lets the CLI reuse surfaces it
    already traced for the printed table."""
    from ..distributed.mesh import SpecLayout

    surfaces = (_surfaces if _surfaces is not None
                else step_comms_surfaces(paths=paths, device=device))
    layout = SpecLayout()
    for s in surfaces:
        s["contract"] = _OUTPUT_CONTRACT.get(s.get("path"), {})
    return analyze_comms_surfaces(
        surfaces,
        contract=layout.step_contract(),
        expected=layout.expected_collectives(),
        mesh_axes=surfaces[0]["mesh_axes"] if surfaces else None,
        budget=smoke_comms_budget(surfaces),
        allowlist=allowlist, name=name)


def sampled_logits_gather_surface(S=2, V=512, tp=2) -> dict:
    """The one documented collective of the sampling path, in isolation:
    [S, V] f32 logits vocab-sharded as the tied lm_head leaves them
    (``SpecLayout.logits()``), gathered whole the way the sampler reads
    them (``fleet.mp_ops.gather_last``). The surface must hold exactly one
    all-gather whose bytes on wire are S * V * 4 * (tp - 1) / tp — the pin
    that keeps the inventory's arithmetic honest."""
    from ..distributed.fleet.mp_ops import gather_last
    from ..distributed.mesh import axis_group
    from .core import trace

    with tp_world(tp) as axes:
        group = axis_group("tp")

        def gather(logits):
            return gather_last(logits * 2.0, group)   # scaled while sharded

        local = torch.zeros((S, V // tp), dtype=torch.float32)
        gm = trace(gather, local, stack_traces=True)
        s = traced_comms_surface(
            gm, name="sampled_logits_gather",
            input_specs={"logits": _normalize_spec((None, "tp"))},
            input_bytes={"logits": {"bytes": S * V * 4, "shape": (S, V)}},
            output_specs={"out.0": ()}, mesh_axes=axes, device="cpu")
    s["tp"] = tp
    return s


# ------------------------------------------------------------- fixture mode
def comms_fixture_reports(path):
    """Seeded-violation mode for ``--comms PATH``: a ``.json`` file is a
    synthetic comms surface (JAX's format — keys ``mesh_axes`` /
    ``contract`` / ``actual`` / ``collectives`` / ``buffers`` / ``budget``
    / ``expected_collectives``, all optional, a rule runs iff its section
    is present); a ``.py`` file is a PROGRAM fixture defining
    ``make_program() -> (fn, args)`` (optionally ``EXPECTED_COLLECTIVES``),
    called and traced inside ``tp_world(2)`` (a process group of two ranks:
    the fixture takes ``torch.distributed.group.WORLD``) and inventoried
    for real. Directories run every fixture inside. Everything is strict
    with an empty allowlist: any HIGH exits 1."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.endswith((".py", ".json")))
        out = []
        for n in names:
            out.extend(comms_fixture_reports(os.path.join(path, n)))
        return out
    label = f"comms[{os.path.basename(path)}]"
    if path.endswith(".json"):
        with open(path, "r") as fh:
            spec = json.load(fh)
        return [_json_fixture_report(spec, label)]
    import runpy

    from .core import trace

    mod = runpy.run_path(path)
    if "make_program" not in mod:
        raise ValueError(f"{path}: a .py comms fixture must define "
                         "make_program() -> (fn, args)")
    with tp_world(2):
        fn, args = mod["make_program"]()
        gm = trace(fn, *args, stack_traces=True)
        surface = traced_comms_surface(gm, name=os.path.basename(path))
    return [analyze_comms_surfaces(
        [surface], expected=mod.get("EXPECTED_COLLECTIVES", {}),
        strict=True, allowlist=Allowlist([]), name=label)]


def _json_fixture_report(spec, label) -> Report:
    name = spec.get("name", label)
    surface = {
        "name": name,
        "mesh_axes": dict(spec.get("mesh_axes", {})),
        "tp": spec.get("mesh_axes", {}).get("tp", 1),
        "ops": [],
        "input_specs": {k: _normalize_spec(v)
                        for k, v in spec.get("actual", {}).items()},
        "input_bytes": {},
        "output_specs": {},
        "contract": {},
        "bytes_per_launch": 0,
    }
    for c in spec.get("collectives", ()):
        dtype, nbytes = _hlo_result_bytes(c["result"])
        group = int(c.get("group_size", 1))
        count = int(c.get("count", 1))
        surface["ops"].append(CollectiveOp(
            kind=c["kind"], result=c["result"], dtype=dtype,
            buffer_bytes=nbytes, group_size=group, count=count,
            wire_bytes=bytes_on_wire(c["kind"], nbytes, group) * count,
            where=c.get("where", name)))
    surface["bytes_per_launch"] = sum(op.wire_bytes
                                      for op in surface["ops"])
    for b in spec.get("buffers", ()):
        import numpy as np

        nbytes = int(np.prod(b["shape"]) * np.dtype(b["dtype"]).itemsize)
        surface["input_bytes"][b["label"]] = {"bytes": nbytes,
                                              "shape": tuple(b["shape"])}
        surface["input_specs"].setdefault(
            b["label"], _normalize_spec(b.get("spec", ())))
    budget = None
    if "budget" in spec:
        budget = CommsBudget.from_json(spec["budget"])
    expected = spec.get("expected_collectives")
    if expected is not None:
        expected = {k: "declared by fixture" for k in expected}
    return analyze_comms_surfaces(
        [surface], contract=spec.get("contract"), expected=expected or {},
        mesh_axes=spec.get("mesh_axes") or None, budget=budget,
        strict=True, allowlist=Allowlist([]), name=label)


# Intentional, justified cross-card traffic shipped with the port, kept
# VISIBLE (Report.suppressed). JAX's three implicit-reshard entries have no
# counterpart: the fused qkv and gate_up projections are cut per head group
# and per half (bridge.shard_state, mark_fused), so no slice straddles a
# shard and no collective patches it; and the port gathers the whole
# vocabulary row before it samples (models/generation.py _whole_vocab), so
# there is no distributed sort.
BUILTIN_COMMS_ALLOWLIST = Allowlist([
    # dp is the replica-FLEET axis: data parallelism lives at the
    # scheduler-replica level (ReplicaFleet), so no program input is cut
    # over it — and serving_mesh keeps declaring it, so fleet meshes and
    # program meshes stay the same object.
    AllowlistEntry(
        "dead-mesh-axis", contains="'dp'",
        reason="dp is the replica-fleet axis (scheduler-level data "
               "parallelism, distributed/mesh.py serving_mesh): no "
               "step-program input is cut over it by design"),
])
