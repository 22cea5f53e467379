"""Graph lint core: trace a program, hand its FX graph to the rules, report
— the counterpart of ``paddle_tpu/analysis/core.py``.

The JAX package lints a jaxpr. The port's programs are captured into CUDA
graphs, which expose no program text (``jit/train.py``: ``TrainStep.lowered``
raises), so the program the rules read is an FX graph traced with fake
tensors (``torch.fx.experimental.proxy_tensor.make_fx(...,
tracing_mode="fake")``): every aten operator and every port kernel (each a
``torch.library`` operator with a fake) is one node, in-place writes
(``copy_``, ``index_put_``, ``_foreach_*_``) stay visible as nodes, and
each node's ``meta["val"]`` carries its shape, dtype, device and storage.
Tracing launches nothing, reads no device memory and changes no parameter,
optimizer count or RNG state.

Entry points (all return a ``Report``):

* ``analyze(fn, *args, **kwargs)`` — trace ``fn`` over fake copies of the
  tensor arguments and lint the graph.
* ``analyze_graph(gm, ...)`` (JAX's ``analyze_jaxpr``, kept under that name
  too) — lint an already traced ``torch.fx.GraphModule``.
* ``analyze_exported(ep, ...)`` (JAX's ``analyze_lowered``, kept under that
  name too) — lint the ``torch.export.ExportedProgram`` that ``jit.save``
  writes: donation from its graph signature's mutations, host-sync over its
  nodes, constant bloat over its constants (JAX's reduced rule set).
* ``analyze_train_step(step, *args, **kwargs)`` — lint a ``jit.TrainStep``
  exactly as its next call would run it (``_program``, the staged inputs,
  ``_step`` under the key's AMP state) over the step's state tensors
  (parameters, buffers, accumulators) and its staged batch, step counter
  and learning rate. Nothing is captured or launched; ``opt._step_count``,
  the step's seed, the dropout generator and every parameter are left as
  they were.
* ``trace_runner(model, run)`` — the FX graph of a step program
  (``jit.graphs.StepRunner`` built by ``models/generation.py``) over its
  decode state, pools, input and output buffers (and adapter bank).

A rule that crashes on an exotic graph becomes an ``info`` ``rule-error``
finding, never an exception in the caller's loop.
"""
from __future__ import annotations

import contextlib
import inspect

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree

from .findings import BUILTIN_ALLOWLIST, HIGH, INFO, WARN, Allowlist, Finding

__all__ = ["Thresholds", "InputInfo", "Program", "Report", "analyze",
           "analyze_graph", "analyze_jaxpr", "analyze_exported",
           "analyze_lowered", "analyze_train_step", "trace", "trace_runner",
           "trace_train_step", "analyze_runner", "iter_eqns",
           "iter_consts", "source_of", "op_name",
           "storages_of", "tensor_bytes", "fmt_bytes"]


class Thresholds:
    """Byte/count knobs the rules read. Defaults target real models; tests
    and the CLI can tighten them to exercise rules on smoke programs."""

    def __init__(self, donation_min_bytes=1 << 20, const_high_bytes=1 << 20,
                 const_warn_bytes=128 << 10, max_findings_per_rule=16):
        self.donation_min_bytes = int(donation_min_bytes)
        self.const_high_bytes = int(const_high_bytes)
        self.const_warn_bytes = int(const_warn_bytes)
        self.max_findings_per_rule = int(max_findings_per_rule)


def tensor_bytes(t) -> int:
    """numel x itemsize of a (fake) tensor; 0 for anything else."""
    if not isinstance(t, torch.Tensor):
        return 0
    try:
        return int(t.numel()) * t.element_size()
    except Exception:
        return 0


def fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def storages_of(val):
    """[(storage key, storage bytes, tensor)] of a node value: a tensor, or
    the tensors of a tuple / list. The key identifies the storage, so a view
    and its base share one."""
    out = []
    for t in pytree.tree_leaves(val):
        if not isinstance(t, torch.Tensor):
            continue
        try:
            st = t.untyped_storage()
            out.append((StorageWeakRef(st), int(st.nbytes()), t))
        except Exception:
            continue
    return out


class InputInfo:
    """One program input: its path, the placeholder ``node``, its fake
    ``val`` and ``donated``: True when the program writes it in place (the
    port's counterpart of a donated buffer) or the caller declared it
    donated, False when it is only read, None when unknown."""

    __slots__ = ("path", "node", "val", "donated")

    def __init__(self, path, node, val, donated):
        self.path = path
        self.node = node
        self.val = val
        self.donated = donated

    @property
    def nbytes(self) -> int:
        return tensor_bytes(self.val)


class Program:
    """Everything a rule may inspect about one traced program: the
    ``GraphModule``, its inputs, the outputs it returns (``outputs``, FX
    nodes; program outputs that alias an input are writes in place), the
    declared process groups a collective may use (``mesh_axes``: group
    names, ``ProcessGroup``s, or a mapping of axis to group), whether it is
    a hot per-step program, the static arguments closed over, and the
    constants (``constants``: (label, tensor, users) triples; by default
    the graph's tensor attributes)."""

    def __init__(self, name, gm, inputs, *, outputs=None, mesh_axes=None,
                 hot=True, static_args=None, number_args=None,
                 thresholds=None, constants=None, device_type=None,
                 judged=None):
        self.name = name
        self.gm = gm
        self.inputs = inputs
        self.outputs = (list(outputs) if outputs is not None
                        else _output_nodes(gm))
        self.mesh_axes = mesh_axes
        self.hot = bool(hot)
        self.static_args = static_args or {}
        self.number_args = number_args or {}    # label -> Python number
        self.thresholds = thresholds or Thresholds()
        self._constants = constants
        self.device_type = device_type or _device_type(inputs)
        self.judged = judged        # None: every input; else input indices

    @property
    def graph(self):
        return self.gm.graph

    def constants(self):
        if self._constants is not None:
            return list(self._constants)
        return [(label, val, users) for label, val, users, _stack
                in iter_consts(self.gm)]


def _device_type(inputs):
    for info in inputs:
        if isinstance(info.val, torch.Tensor):
            return info.val.device.type
    return ""


def _output_nodes(gm):
    out = next((n for n in gm.graph.nodes if n.op == "output"), None)
    if out is None:
        return []
    return [n for n in pytree.tree_leaves(out.args[0])
            if isinstance(n, torch.fx.Node)]


class Report:
    """The outcome of linting one program: kept findings, suppressed
    (finding, allowlist-entry) pairs, and the rules that ran."""

    def __init__(self, name, findings, suppressed, rules_run):
        self.name = name
        self.findings = list(findings)
        self.suppressed = list(suppressed)
        self.rules_run = tuple(rules_run)

    def high(self):
        return [f for f in self.findings if f.severity == HIGH]

    def by_rule(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def by_severity(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "program": self.name,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [
                {"finding": f.to_dict(), "reason": e.reason}
                for f, e in self.suppressed
            ],
            "by_rule": self.by_rule(),
            "high_total": len(self.high()),
        }

    def render(self) -> str:
        lines = [f"== {self.name}: {len(self.findings)} finding(s), "
                 f"{len(self.suppressed)} allowlisted =="]
        order = {HIGH: 0, WARN: 1, INFO: 2}
        for f in sorted(self.findings, key=lambda f: order[f.severity]):
            lines.append("  " + f.render().replace("\n", "\n  "))
        for f, e in self.suppressed:
            lines.append(f"  [allowlisted] {f.rule}: {f.message}")
            lines.append(f"      reason: {e.reason}")
        if not self.findings and not self.suppressed:
            lines.append("  clean")
        return "\n".join(lines)


# ------------------------------------------------------------------ walking
def _sub_modules(node, gm):
    """(tag, GraphModule) pairs a node runs: a ``call_module`` of a
    GraphModule, or the graph attributes a higher-order operator takes."""
    found = []
    if node.op == "call_module":
        sub = getattr(gm, str(node.target), None)
        if isinstance(sub, torch.fx.GraphModule):
            found.append((str(node.target), sub))
    elif node.op == "call_function":
        for a in pytree.tree_leaves((node.args, node.kwargs)):
            if isinstance(a, torch.fx.Node) and a.op == "get_attr":
                sub = getattr(gm, str(a.target), None)
                if isinstance(sub, torch.fx.GraphModule):
                    found.append((str(a.target), sub))
    return found


def op_name(node) -> str:
    """'aten.mm', 'paddle_tpu_torch.flash_fwd', '_c10d_functional.
    all_reduce', or the callable's name."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return f"{t.namespace}.{t._opname}"
    if isinstance(t, torch._ops.OpOverloadPacket):
        return str(t).replace("::", ".")
    return getattr(t, "__name__", str(t))


def iter_eqns(gm):
    """Yield (node, stack, scope) over every ``call_function`` /
    ``call_module`` node of the program, recursing into submodules and the
    subgraphs of higher-order operators. ``stack`` names the enclosing
    subgraphs; ``scope`` is kept for the JAX signature (a flat FX graph
    binds no mesh axes)."""
    if isinstance(gm, Program):
        gm = gm.gm

    def walk(g, stack):
        for node in g.graph.nodes:
            if node.op not in ("call_function", "call_module"):
                continue
            yield node, stack, ()
            for tag, sub in _sub_modules(node, g):
                yield from walk(sub, stack + (f"{op_name(node)}:{tag}",))

    yield from walk(gm, ())



def iter_consts(gm):
    """Yield (label, tensor, users, stack) for every tensor attribute a
    graph reads through ``get_attr`` (constants lifted at trace time),
    recursing into subgraphs. ``users``: the targets of the nodes reading
    it (``aten.lift_fresh_copy`` marks a tensor made from host data inside
    the trace)."""
    if isinstance(gm, Program):
        gm = gm.gm

    def walk(g, stack):
        for node in g.graph.nodes:
            if node.op != "get_attr":
                continue
            val = getattr(g, str(node.target), None)
            if isinstance(val, torch.Tensor):
                yield (str(node.target), val,
                       tuple(op_name(u) for u in node.users), stack)
            elif isinstance(val, torch.fx.GraphModule):
                yield from walk(val, stack + (str(node.target),))

    yield from walk(gm, ())


def source_of(node) -> str:
    """User-frame provenance of a node, 'file:line (fn)', else the module
    path it ran in ('module gpt.h.0.attn'), else ''."""
    trace = node.meta.get("stack_trace") if node is not None else None
    if trace:
        frames = [ln.strip() for ln in trace.strip().splitlines()
                  if ln.strip().startswith("File ")]
        if frames:
            # File "path", line N, in fn
            last = frames[-1]
            try:
                path = last.split('"')[1]
                line = last.split("line ")[1].split(",")[0]
                fn = last.rsplit(" in ", 1)[1]
                return f"{path}:{line} ({fn})"
            except IndexError:
                return last
    stack = node.meta.get("nn_module_stack") if node is not None else None
    if stack:
        fqn = list(stack.values())[-1][0]
        if fqn:
            return f"module {fqn}"
    return ""


# ------------------------------------------------------------ rule running
def _run_rules(prog, rules, allowlist):
    from .rules import RULES

    selected = RULES if rules is None else {r: RULES[r] for r in rules}
    findings = []
    for rule_id, rule_fn in selected.items():
        try:
            got = list(rule_fn(prog))
        except Exception as e:  # a broken rule must not break the caller
            got = [Finding("rule-error", INFO,
                           f"rule {rule_id} crashed: {e!r}"[:300],
                           subject=prog.name)]
        cap = prog.thresholds.max_findings_per_rule
        if len(got) > cap:
            got = got[:cap] + [Finding(
                rule_id, got[cap].severity,
                f"... {len(got) - cap} more {rule_id} finding(s) truncated",
                subject=prog.name)]
        for f in got:
            f.subject = f.subject or prog.name
        findings.extend(got)
    return _report(prog.name, findings, allowlist, prog.device_type,
                   tuple(selected))


def _report(name, findings, allowlist, device_type, rules_run):
    if allowlist is None:
        allowlist = BUILTIN_ALLOWLIST
    kept, suppressed = allowlist.apply(findings, device_type)
    return Report(name, kept, suppressed, rules_run)


# ------------------------------------------------------------------ tracing
_MAKE_FX_ARGS = set(inspect.signature(make_fx).parameters)


@contextlib.contextmanager
def _port_frames():
    """Within: make_fx keeps a node's frames in the port's source, not only
    those named ``forward``, so an operator a step body calls outside any
    module (the sampled-logits gather) still names its line. A torch
    without the tracer's frame filter keeps its own rule."""
    from torch.fx.experimental import proxy_tensor

    cls = getattr(proxy_tensor, "PythonKeyTracer", None)
    base = getattr(cls, "_filter_traceback_frames", None)
    if base is None:
        yield
        return
    own = "_filter_traceback_frames" in cls.__dict__

    def keep(self, summary):
        port = [f for f in summary
                if "paddle_tpu_torch" in f.filename.replace("\\", "/")
                and "/analysis/" not in f.filename.replace("\\", "/")]
        if not port:
            return base(self, summary)
        import traceback

        return traceback.StackSummary.from_list(port)

    cls._filter_traceback_frames = keep
    try:
        yield
    finally:
        if own:
            cls._filter_traceback_frames = base
        else:
            del cls._filter_traceback_frames


def trace(fn, *args, stack_traces=False):
    """make_fx of ``fn(*args)`` over fake copies of the tensors in ``args``
    (any pytree): nothing runs on a device and no tensor is written.
    Closed-over tensors become graph constants. ``stack_traces``: record
    each node's frames in the port too (the comms inventory's
    provenance)."""
    kw = {"tracing_mode": "fake"}
    # the module path of each node is its provenance (``source_of``); a
    # stack trace per node costs a third more tracing time
    for flag, value in (("_allow_non_fake_inputs", True),
                        ("record_module_stack", True),
                        ("record_stack_traces", bool(stack_traces))):
        if flag in _MAKE_FX_ARGS:
            kw[flag] = value
    with _port_frames() if stack_traces else contextlib.nullcontext():
        return make_fx(fn, **kw)(*args)


def _mutated_storages(gm):
    """Storage keys that an in-place operator of the graph writes."""
    written = set()
    for node, _stack, _scope in iter_eqns(gm):
        t = node.target
        schema = getattr(t, "_schema", None)
        if schema is None:
            continue
        for i, arg in enumerate(schema.arguments):
            info = arg.alias_info
            if info is None or not info.is_write:
                continue
            if arg.kwarg_only or i >= len(node.args):
                val = node.kwargs.get(arg.name)
            else:
                val = node.args[i]
            for a in pytree.tree_leaves(val):
                if isinstance(a, torch.fx.Node):
                    for key, _n, _t in storages_of(a.meta.get("val")):
                        written.add(key)
    return written


def _inputs_of(gm, labels, donated=None):
    """InputInfo per placeholder: ``labels`` name them in order; donated
    is True where the graph writes the placeholder's storage in place
    (or ``donated`` declares it)."""
    written = _mutated_storages(gm)
    infos = []
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for i, node in enumerate(phs):
        val = node.meta.get("val")
        label = labels[i] if labels and i < len(labels) else f"arg[{i}]"
        if donated is not None and i < len(donated):
            flag = bool(donated[i])
        else:
            flag = any(k in written for k, _n, _t in storages_of(val))
        infos.append(InputInfo(label, node, val, flag))
    return infos


def _is_number(v) -> bool:
    return isinstance(v, (int, float, complex)) and not isinstance(v, bool)


def _traceable_leaf(v) -> bool:
    return (v is None or isinstance(v, (torch.Tensor, bool))
            or _is_number(v) or hasattr(v, "_value"))


def _is_static_arg(val) -> bool:
    """A top-level argument is static (closed over, never traced) when any
    of its leaves is neither a tensor nor a number."""
    leaves = pytree.tree_leaves(val)
    if not leaves:
        return False
    return not all(_traceable_leaf(v) for v in leaves)


def _unwrap(v):
    """The torch tensor of a port ``Tensor`` (which carries ``_value``)."""
    inner = getattr(v, "_value", None)
    return inner if isinstance(inner, torch.Tensor) else v


def _key_label(path) -> str:
    return pytree.keystr(path)


def _flat_call(fn, args, kwargs, arg_labels=None):
    """(traced fn over the tensor leaves, tensors, labels, static args,
    number args): tensors become placeholders; static arguments and Python
    numbers are closed over as the program would bake them."""
    static, numbers = {}, {}
    dyn = []
    for i, a in enumerate(args):
        label = (arg_labels[i] if arg_labels is not None
                 and i < len(arg_labels) else f"[{i}]")
        if _is_static_arg(a):
            static[label] = a
        dyn.append((label, a))
    for k, v in kwargs.items():
        if _is_static_arg(v):
            static[f"['{k}']"] = v
        dyn.append((f"['{k}']", v))
    tree = [pytree.tree_map(_unwrap, v) if label not in static else None
            for label, v in dyn]
    flat, spec = pytree.tree_flatten_with_path(tree)
    tensors, labels, slots = [], [], []
    leaves = []
    for path, leaf in flat:
        label = dyn[path[0].idx][0] + _key_label(path[1:])
        if isinstance(leaf, torch.Tensor):
            slots.append(len(leaves))
            tensors.append(leaf)
            labels.append(label)
        elif _is_number(leaf):
            numbers[label] = leaf
        leaves.append(leaf)
    _, treedef = pytree.tree_flatten(tree)
    n_pos = len(args)

    def traced(*ts):
        vals = list(leaves)
        for slot, t in zip(slots, ts):
            vals[slot] = t
        rebuilt = pytree.tree_unflatten(vals, treedef)
        full = []
        for j, (label, v) in enumerate(dyn):
            full.append(static[label] if label in static else rebuilt[j])
        return fn(*full[:n_pos], **{k: full[n_pos + j]
                                    for j, k in enumerate(kwargs)})

    return traced, tensors, labels, static, numbers


_SYNC_ERRORS = ("DataDependentOutputException", "DynamicOutputShapeException",
                "GuardOnDataDependentSymNode")


def _trace_failure(name, e, static_args, hot):
    """Findings for a program that did not trace: a data-dependent stop is
    itself a host synchronisation (the program reads device data on the
    host); any other error is recorded, with the static-argument half of
    recompile-hazard, which needs no graph."""
    from .rules import static_arg_findings

    findings = static_arg_findings(static_args)
    kind = type(e).__name__
    if kind in _SYNC_ERRORS or "data-dependent" in str(e).lower():
        func = getattr(e, "func", None)
        findings.append(Finding(
            "host-sync", HIGH if hot else WARN,
            f"the program reads device data on the host"
            f"{f' ({func})' if func is not None else ''}: tracing stops at "
            "a data-dependent value — a captured step cannot hold it",
            where=_frame_of(e),
            remediation="keep the value on the device (torch.where, masks) "
                        "or fetch it outside the step program"))
    findings.append(Finding(
        "rule-error", INFO,
        f"program failed to trace, graph rules skipped: {e!r}"[:300],
        subject=name))
    for f in findings:
        f.subject = f.subject or name
    return findings


def _frame_of(e) -> str:
    """The innermost traceback frame outside torch, 'file:line (fn)'."""
    tb = e.__traceback__
    best = ""
    while tb is not None:
        code = tb.tb_frame.f_code
        path = code.co_filename
        if "/torch/" not in path and "analysis/core.py" not in path:
            best = f"{path}:{tb.tb_lineno} ({code.co_name})"
        tb = tb.tb_next
    return best


# ------------------------------------------------------------- entry points
def analyze(fn, *args, _name=None, _mesh_axes=None, _hot=True,
            _donate_argnums=None, _thresholds=None, _allowlist=None,
            _rules=None, _arg_labels=None, **kwargs):
    """Trace ``fn(*args, **kwargs)`` over fake tensors and lint the graph.

    Keyword knobs are underscore-prefixed so they never collide with the
    analyzed function's own. ``_donate_argnums`` names the positional
    arguments that hold state the program updates (the only ones
    ``donation-miss`` judges; default: every input); ``_mesh_axes``
    declares the process groups a collective may use; ``_hot=False``
    relaxes host-sync to warnings (not a per-step program)."""
    name = _name or getattr(fn, "__name__", None) or repr(fn)
    traced, tensors, labels, static, numbers = _flat_call(
        fn, args, kwargs, _arg_labels)
    try:
        gm = trace(traced, *tensors)
    except Exception as e:
        findings = _trace_failure(name, e, static, _hot)
        return _report(name, findings, _allowlist,
                       tensors[0].device.type if tensors else "",
                       ("host-sync", "recompile-hazard"))
    judged = None
    if _donate_argnums is not None:
        wanted = tuple(_arg_labels[i] if _arg_labels is not None
                       and i < len(_arg_labels) else f"[{i}]"
                       for i in _donate_argnums)
        judged = {i for i, label in enumerate(labels)
                  if label.startswith(wanted)}
    prog = Program(name, gm, _inputs_of(gm, labels), mesh_axes=_mesh_axes,
                   hot=_hot, static_args=static, number_args=numbers,
                   thresholds=_thresholds, judged=judged)
    return _run_rules(prog, _rules, _allowlist)


def analyze_graph(gm, *, donated=None, arg_names=None, name="graph",
                  mesh_axes=None, hot=True, thresholds=None, allowlist=None,
                  rules=None):
    """Lint an already traced ``GraphModule``. ``donated`` optionally flags
    the placeholders the caller hands over (default: those the graph
    writes in place); ``arg_names`` labels them."""
    prog = Program(name, gm, _inputs_of(gm, arg_names, donated),
                   mesh_axes=mesh_axes, hot=hot, thresholds=thresholds)
    return _run_rules(prog, rules, allowlist)


analyze_jaxpr = analyze_graph


def analyze_exported(ep, *, name=None, hot=True, thresholds=None,
                     allowlist=None):
    """Lint a ``torch.export.ExportedProgram`` (``jit.save`` writes one):
    donation judged from the graph signature (an input the program mutates
    is written back in place), host-sync over its nodes, constant bloat
    over its lifted constants. JAX's reduced rule set."""
    from torch.export.graph_signature import InputKind

    name = name or "exported"
    sig = ep.graph_signature
    gm = ep.graph_module
    mutated = set(sig.buffers_to_mutate.values()) | set(
        getattr(sig, "user_inputs_to_mutate", {}).values())
    labels, donated, consts = [], [], []
    for spec in sig.input_specs:
        target = spec.target or spec.arg.name
        labels.append(f"{spec.kind.name.lower()}:{target}")
        donated.append(target in mutated or spec.arg.name in mutated)
        if spec.kind in (InputKind.CONSTANT_TENSOR,):
            val = ep.constants.get(target)
            if isinstance(val, torch.Tensor):
                consts.append((target, val, ()))
    user_out = set(sig.user_outputs)
    outputs = [n for n in _output_nodes(gm) if n.name in user_out]
    prog = Program(name, gm, _inputs_of(gm, labels, donated),
                   outputs=outputs, hot=hot, thresholds=thresholds,
                   constants=consts)
    return _run_rules(prog, ("donation-miss", "host-sync", "constant-bloat"),
                      allowlist)


analyze_lowered = analyze_exported


# --------------------------------------------------------- the train step
@contextlib.contextmanager
def _swapped(slots):
    """Within: each (dict, key, value) slot holds value; restored after."""
    saved = [(d, k, d[k]) for d, k, _v in slots]
    try:
        for d, k, v in slots:
            d[k] = v
        yield
    finally:
        for d, k, v in reversed(saved):
            d[k] = v


def _module_slots(model, by_id):
    """(store dict, name, owner module) of every parameter / buffer slot of
    ``model`` holding a tensor of ``by_id`` (tied tensors: every slot)."""
    out = []
    for mod in model.modules():
        for store_name in ("_parameters", "_buffers"):
            store = mod.__dict__.get(store_name) or {}
            for k, t in store.items():
                if t is not None and id(t) in by_id:
                    out.append((store, k, mod))
    return out


def _rebind_wrappers(slots):
    """A port ``Layer`` caches a paddle wrapper per parameter whose
    ``_value`` follows the module's tensor on access: point every wrapper
    of a restored slot back at the restored tensor."""
    for store, k, mod in slots:
        wrappers = mod.__dict__.get("_wrappers")
        w = wrappers.get(k) if wrappers else None
        if w is not None and getattr(w, "_value", None) is not store[k]:
            w._value = store[k]


def trace_train_step(step, *args, **kwargs):
    """(GraphModule, labels) of one ``TrainStep`` body as the step's next
    call would run it with this batch: the placeholders are the model's
    parameters and buffers, the optimizer's accumulators and the key's
    staged inputs (batch leaves ``a0``, ..., ``step``, ``lr``), in that
    order. The key's program is made if it is new (the next call makes it
    too); nothing else about the step changes."""
    from ..jit.fingerprint import unflatten
    from ..jit.train import _unwrapped
    from .. import amp

    args, kwargs = _unwrapped((args, kwargs))
    prog = step._program(args, kwargs)
    opt = step.optimizer
    model = step.model
    # torch's own walk: a port Layer's named_parameters() gives wrappers
    named = (list(torch.nn.Module.named_parameters(model))
             + list(torch.nn.Module.named_buffers(model)))
    params = list(step._params)
    accs = [(name, store, p) for name, store in opt._accumulators.items()
            for p in params if id(p) in store]
    staged = prog.inputs.dev
    n_leaves = prog.n_leaves
    state = [t for _, t in named]
    acc_vals = [store[id(p)] for _name, store, p in accs]
    batch = [staged[f"a{i}"] for i in range(n_leaves)]
    tensors = state + acc_vals + batch + [staged["step"], staged["lr"]]
    pnames = {id(p): n for n, p in step._trainable.items()}
    labels = ([f"state['{n}']" for n, _ in named]
              + [f"acc['{a}']['{pnames.get(id(p), '?')}']"
                 for a, _s, p in accs]
              + [f"batch[a{i}]" for i in range(n_leaves)]
              + ["step", "lr"])
    aux_before = [m.l_aux for m in step._aux_layers]

    def body(*ts):
        fake_state = ts[:len(state)]
        fake_accs = ts[len(state):len(state) + len(acc_vals)]
        rest = ts[len(state) + len(acc_vals):]
        fake_batch, fake_step, fake_lr = rest[:n_leaves], rest[-2], rest[-1]
        by_id = {}
        for (_n, real), fake in zip(named, fake_state):
            if real.requires_grad and real.is_floating_point():
                fake.requires_grad_(True)
            by_id.setdefault(id(real), fake)
        mslots = _module_slots(model, by_id)
        slots = [(store, k, by_id[id(store[k])]) for store, k, _m in mslots]
        fake_params = [by_id[id(p)] for p in params]
        fstores = {}
        for (name, _store, p), fake in zip(accs, fake_accs):
            fstores.setdefault(name, {})[id(by_id[id(p)])] = fake
        attrs = {id(by_id[id(p)]): opt._attrs[id(p)] for p in params
                 if id(p) in opt._attrs}
        names = {id(by_id[id(p)]): opt._names[id(p)] for p in params
                 if id(p) in opt._names}
        swaps = slots + [
            (step.__dict__, "_params", fake_params),
            (opt.__dict__, "_accumulators", fstores),
            (opt.__dict__, "_attrs", {**opt._attrs, **attrs}),
            (opt.__dict__, "_names", {**opt._names, **names})]
        fb_args, fb_kwargs = unflatten(prog.structure, list(fake_batch))
        try:
            with _swapped(swaps), amp._restored(prog.amp_state):
                loss, _outs = step._step(fb_args, fb_kwargs, fake_lr,
                                         fake_step)
        finally:
            _rebind_wrappers(mslots)
        return loss

    try:
        with torch.enable_grad():
            gm = trace(body, *tensors)
    finally:
        for m, old in zip(step._aux_layers, aux_before):
            m.l_aux = old
    return gm, labels


def analyze_train_step(step, *args, name=None, thresholds=None,
                       allowlist=None, rules=None, mesh_axes=None, **kwargs):
    """Lint a ``jit.TrainStep`` over the program its next call would run
    with this batch (``trace_train_step``): nothing is captured or
    launched, and the step's counters, RNG and state are left as they
    were. Python numbers in the batch are staged as 0-d tensors by the
    step, but ``aval_fingerprint`` keys on their type: they are the
    recompile-hazard rule's business."""
    from ..jit.train import _unwrapped

    if name is None:
        name = f"train_step:{type(getattr(step, '_inner', step.model)).__name__}"
    a, k = _unwrapped((args, kwargs))
    numbers = {}
    leaves, _ = pytree.tree_flatten_with_path((tuple(a), dict(k)))
    for path, leaf in leaves:
        if _is_number(leaf):
            numbers[_key_label(path)] = leaf
    try:
        gm, labels = trace_train_step(step, *args, **kwargs)
    except Exception as e:
        return _report(name, _trace_failure(name, e, {}, True), allowlist,
                       step.device.type, ("host-sync", "recompile-hazard"))
    prog = Program(name, gm, _inputs_of(gm, labels), mesh_axes=mesh_axes,
                   hot=True, number_args=numbers, thresholds=thresholds)
    return _run_rules(prog, rules, allowlist)


# ---------------------------------------------------------- step programs
def trace_runner(model, run, name="step", stack_traces=False):
    """(GraphModule, labels) of program ``name`` of a runner built by
    ``models/generation.py`` (its ``trace_parts``: the function that builds
    its programs and the tensors they close over). The placeholders are
    those tensors — the decode state (the decode layer's parameters, or
    the cast the runner holds), the pools or dense caches, the adapter
    bank, a dense runner's device carry — then the runner's input and
    output buffers. Nothing runs on a device."""
    parts = getattr(run, "trace_parts", None)
    if parts is None:
        raise ValueError("this runner was not built by a decode path "
                         "(no trace_parts)")
    rebuild, closed = parts
    closed = dict(closed)
    if closed.get("state") is None:
        closed["state"] = dict(model._decode_layer().named_parameters())

    def fn(c, inputs, outputs):
        with torch.no_grad():
            rebuild(c)[name](inputs, outputs)

    traced, tensors, labels, _static, _numbers = _flat_call(
        fn, (closed, dict(run.inputs.dev), dict(run.outputs.dev)), {},
        ("closed", "inputs", "outputs"))
    return trace(traced, *tensors, stack_traces=stack_traces), labels


def analyze_runner(model, run, *, name, programs=("step",), mesh_axes=None,
                   thresholds=None, allowlist=None, rules=None):
    """Lint the programs of one runner (``trace_runner``) as one report."""
    findings, ran = [], ()
    dev = model.device.type
    for prog_name in programs:
        try:
            gm, labels = trace_runner(model, run, prog_name)
        except Exception as e:
            findings += _trace_failure(name, e, {}, True)
            ran = ran or ("host-sync", "recompile-hazard")
            continue
        prog = Program(name, gm, _inputs_of(gm, labels), mesh_axes=mesh_axes,
                       hot=True, thresholds=thresholds, device_type=dev)
        rep = _run_rules(prog, rules, Allowlist([]))
        findings += rep.findings
        ran = rep.rules_run
    return _report(name, findings, allowlist, dev, ran)
