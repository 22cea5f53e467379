"""The graph-lint rule catalog — the counterpart of
``paddle_tpu/analysis/rules.py``, each rule read for an FX graph traced
with fake tensors.

Six rules, under JAX's ids and severities, each a way a captured program
silently burns money on the card:

* ``donation-miss``    — a large input (parameter, accumulator, KV pool)
  whose updated value leaves the program as a new buffer instead of being
  written in place: the card holds the old and the new copy. The port's
  ``TrainStep`` and step programs update in place; this rule catches a
  regression to an out-of-place update.
* ``dtype-upcast``     — a matmul-class node (``mm`` / ``addmm`` / ``bmm``
  / ``baddbmm`` / ``convolution``, or a port attention kernel) fed by a
  ``_to_copy`` that widened a bf16 / f16 tensor to f32 or f64: the product
  runs at the wide type's rate for no numerics the caller asked for. Any
  float64 tensor (of rank > 0) anywhere is flagged too.
* ``host-sync``        — ``aten._local_scalar_dense`` (``.item()``),
  ``nonzero``, ``multinomial``, a copy to the CPU from another device, or a
  callback / print node inside a hot program, each on a value that comes
  from the program's inputs. These are the nodes that break a CUDA-graph
  capture (nothing in a captured body may wait on the host).
* ``constant-bloat``   — tensors lifted into the program as constants
  (``get_attr``, ``ExportedProgram.constants``) over the thresholds.
* ``recompile-hazard`` — arguments that put a new key in the port's
  capture caches on each call: Python numbers (``TrainStep._arg_avals`` /
  ``jit.fingerprint.aval_fingerprint`` keys them by type, and a plain
  program bakes their value), 0-d tensors closed over and baked into the
  capture, identity-hashed or unhashable static arguments.
* ``collective-axis``  — ``torch.ops._c10d_functional.*`` and c10d nodes
  whose process group is not one of the declared mesh's groups (or, with
  no mesh declared, names no live group).

Rules are pure functions ``rule(Program) -> [Finding]`` registered in
``RULES``; the runner in ``core.py`` caps, attributes and allowlists them.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .core import fmt_bytes, iter_eqns, op_name, source_of, storages_of
from .findings import HIGH, WARN, Finding

__all__ = ["RULES", "static_arg_findings"]

NARROW = {torch.bfloat16, torch.float16}
WIDE = {torch.float32, torch.float64}
MXU_OPS = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm",
           "aten.convolution", "aten.matmul", "aten.linear",
           "aten._scaled_dot_product_flash_attention",
           "aten._scaled_dot_product_efficient_attention",
           "aten._scaled_dot_product_cudnn_attention",
           "aten.scaled_dot_product_attention",
           "paddle_tpu_torch.flash_fwd", "paddle_tpu_torch.flash_bwd_dq",
           "paddle_tpu_torch.flash_bwd_dkv", "paddle_tpu_torch.paged_decode",
           "paddle_tpu_torch.dense_decode"}
CONVERT_OPS = {"aten._to_copy", "aten.to", "prims.convert_element_type"}
# shape / layout operators that carry an upcast value unchanged into a
# matmul
LAYOUT_OPS = {"aten.view", "aten._unsafe_view", "aten.reshape", "aten.t",
              "aten.transpose", "aten.permute", "aten.expand",
              "aten.clone", "aten.contiguous", "aten.slice", "aten.select",
              "aten.unsqueeze", "aten.squeeze", "aten.alias", "aten.detach",
              "aten.cat", "aten.index_select", "aten.gather",
              "aten.repeat_interleave", "aten.index", "aten.flatten",
              "aten.unflatten", "aten.split", "aten.split_with_sizes",
              "aten.chunk", "aten.narrow", "aten.as_strided", "aten.unbind",
              "aten.repeat", "aten.copy"}
SYNC_OPS = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
            "aten.multinomial", "aten.masked_select", "aten._unique2",
            "aten.unique_consecutive", "aten.unique_dim", "aten.is_nonzero",
            "aten.equal"}


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _arg_nodes(node):
    return [a for a in pytree.tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node)]


def _ancestors(node, memo):
    """The placeholders ``node`` depends on (memoised, iterative)."""
    if node in memo:
        return memo[node]
    stack, order = [node], []
    while stack:
        n = stack.pop()
        if n in memo or n in order:
            continue
        order.append(n)
        stack.extend(p for p in n.all_input_nodes if p not in memo)
    for n in reversed(order):
        acc = {n} if n.op == "placeholder" else set()
        for p in n.all_input_nodes:
            acc |= memo.get(p, set())
        memo[n] = acc
    return memo[node]


# ------------------------------------------------------------ donation-miss
def _shape_key(t):
    """(shape, dtype) as a hashable key; symbolic sizes by their text."""
    return (tuple(str(d) for d in t.shape), t.dtype)


def rule_donation_miss(prog):
    """Large inputs whose updated value leaves as a new buffer (a
    same-shaped output computed from them) instead of being written in
    place: the card holds two copies."""
    th = prog.thresholds.donation_min_bytes
    in_keys = set()
    for info in prog.inputs:
        in_keys |= {k for k, _n, _t in storages_of(info.val)}
    fresh = {}          # (shape, dtype) -> [output nodes on new storage]
    for node in prog.outputs:
        for key, _n, t in storages_of(_val(node)):
            if key in in_keys:
                continue                # the input itself: written in place
            fresh.setdefault(_shape_key(t), []).append(node)
    memo: dict = {}
    findings = []
    for i, info in enumerate(prog.inputs):
        if info.donated or not isinstance(info.val, torch.Tensor):
            continue
        if prog.judged is not None and i not in prog.judged:
            continue
        nbytes = info.nbytes
        if nbytes < th:
            continue
        key = _shape_key(info.val)
        hit = next((n for n in fresh.get(key, ())
                    if info.node in _ancestors(n, memo)), None)
        if hit is None:
            continue
        fresh[key].remove(hit)          # each output replaces one input
        dt = str(info.val.dtype).replace("torch.", "")
        findings.append(Finding(
            "donation-miss", HIGH,
            f"input {info.path} ({fmt_bytes(nbytes)}, {dt}"
            f"{list(info.val.shape)}) is updated into a new output buffer "
            f"instead of in place — the card holds two copies",
            where=info.path,
            remediation="write the update into the input (copy_ or an "
                        "in-place operator, as TrainStep and the step "
                        "programs do); saves "
                        f"{fmt_bytes(nbytes)} of device memory"))
    return findings


# ------------------------------------------------------------- dtype-upcast
def _convert_target(node):
    """The dtype a conversion node produces, or None."""
    dt = node.kwargs.get("dtype")
    if dt is None and len(node.args) > 1 and isinstance(node.args[1],
                                                         torch.dtype):
        dt = node.args[1]
    if dt is None:
        v = _val(node)
        dt = v.dtype if isinstance(v, torch.Tensor) else None
    return dt


def rule_dtype_upcast(prog):
    """f32/f64 upcasts of bf16/f16 tensors feeding matmul-class nodes, and
    any float64 tensor of rank > 0 (an accidental promotion)."""
    findings = []
    tainted: dict = {}          # node -> source dtype name
    first_f64 = None
    for node, stack, _scope in iter_eqns(prog.gm):
        name = op_name(node)
        if first_f64 is None:
            for _k, _n, t in storages_of(_val(node)):
                if t.dtype == torch.float64 and t.dim() > 0:
                    users = ", ".join(sorted({op_name(u)
                                              for u in node.users}))
                    first_f64 = (source_of(node)
                                 or f"{name} -> {users or 'output'}")
                    break
        args = _arg_nodes(node)
        if name in MXU_OPS:
            hit = [tainted[a] for a in args if a in tainted]
            if hit:
                out = _val(node)
                out = out[0] if isinstance(out, (tuple, list)) else out
                odt = (str(out.dtype).replace("torch.", "")
                       if isinstance(out, torch.Tensor) else "?")
                findings.append(Finding(
                    "dtype-upcast", HIGH,
                    f"{name} consumes operand(s) upcast from {hit[0]} — the "
                    f"product runs in {odt} at a fraction of the narrow "
                    "type's tensor-core rate"
                    + (f" (inside {'/'.join(stack)})" if stack else ""),
                    where=source_of(node),
                    remediation="keep the operands in their narrow dtype "
                                "(drop the .float() / .to()) and accumulate "
                                "in f32 inside the product instead"))
        if name in CONVERT_OPS and args:
            src = _val(args[0])
            dst = _convert_target(node)
            if (isinstance(src, torch.Tensor) and src.is_floating_point()
                    and dst is not None):
                if src.dtype in NARROW and dst in WIDE:
                    tainted[node] = str(src.dtype).replace("torch.", "")
                elif args[0] in tainted and dst not in NARROW:
                    tainted[node] = tainted[args[0]]
        elif name in LAYOUT_OPS and args and args[0] in tainted:
            tainted[node] = tainted[args[0]]
        elif name == "getitem" and args and args[0] in tainted:
            tainted[node] = tainted[args[0]]
    for info in prog.inputs:
        t = info.val
        if (first_f64 is None and isinstance(t, torch.Tensor)
                and t.dtype == torch.float64 and t.dim() > 0):
            first_f64 = f"program input {info.path}"
    if first_f64 is not None:
        findings.append(Finding(
            "dtype-upcast", HIGH,
            f"float64 appears in the program (first at {first_f64}) — on "
            "the card f64 products run at a small fraction of the f32 / "
            "bf16 rate, and usually mean an accidental promotion",
            where=first_f64,
            remediation="cast to float32/bfloat16 explicitly"))
    return findings


# --------------------------------------------------------------- host-sync
def _to_host(node, prog_dev):
    """A copy from the program's device to the CPU."""
    name = op_name(node)
    if prog_dev in ("", "cpu"):
        return False
    if name in ("aten._to_copy", "aten.to", "aten.copy_", "aten.copy"):
        out = _val(node)
        if name == "aten.copy_" and node.args:
            out = _val(node.args[0])
        return (isinstance(out, torch.Tensor)
                and out.device.type == "cpu")
    return False


def rule_host_sync(prog):
    """Nodes that make the device wait for the host on every execution —
    and that a CUDA-graph capture refuses."""
    findings = []
    memo: dict = {}
    dev = prog.device_type
    for node, stack, _scope in iter_eqns(prog.gm):
        name = op_name(node)
        sync = name in SYNC_OPS or _to_host(node, dev)
        cb = "callback" in name or name.endswith("print")
        if not (sync or cb):
            continue
        if sync and not cb:
            roots = set()
            for a in _arg_nodes(node):
                roots |= _ancestors(a, memo)
            if not any(r.op == "placeholder" for r in roots):
                continue                # host data made inside the trace
        sev = HIGH if prog.hot else WARN
        findings.append(Finding(
            "host-sync", sev,
            f"{name}{' in a hot-path program' if prog.hot else ''}"
            f"{' [' + '/'.join(stack) + ']' if stack else ''} makes the "
            "device wait for the host every execution (a CUDA-graph "
            "capture refuses it)",
            where=source_of(node),
            remediation="keep the value on the device (torch.where, "
                        "masks, fixed-length writes) or fetch results "
                        "outside the step program"))
    return findings


# ------------------------------------------------------------ constant-bloat
def rule_constant_bloat(prog):
    """Tensors baked into the program as constants above the byte
    thresholds: device memory per captured program, re-staged per trace."""
    th = prog.thresholds
    findings = []
    for label, val, _users in prog.constants():
        nbytes = int(val.numel()) * val.element_size()
        if nbytes < th.const_warn_bytes:
            continue
        sev = HIGH if nbytes >= th.const_high_bytes else WARN
        dt = str(val.dtype).replace("torch.", "")
        findings.append(Finding(
            "constant-bloat", sev,
            f"constant {dt}{list(val.shape)} ({fmt_bytes(nbytes)}) is baked "
            f"into the program as {label} — it is held per program and "
            "re-staged on every trace",
            where=label,
            remediation="pass the tensor as an argument (a parameter, a "
                        "buffer or a staged input) instead of closing over "
                        "it"))
    return findings


# ---------------------------------------------------------- recompile-hazard
def _default_hash_identity(v) -> bool:
    t = type(v)
    return (getattr(t, "__hash__", None) is object.__hash__
            and getattr(t, "__eq__", None) is object.__eq__)


def rule_recompile_hazard(prog):
    """Arguments and closures that put a new key in a capture cache per
    call — the runtime recompile sentinel's trigger, caught at trace
    time."""
    findings = []
    for label, v in prog.number_args.items():
        findings.append(Finding(
            "recompile-hazard", WARN,
            f"argument {label} is a Python {type(v).__name__}: "
            "aval_fingerprint keys it by type, so alternating Python and "
            "NumPy / tensor scalars across calls captures anew, and a "
            "program that bakes the value ignores a change",
            where=label,
            remediation="pass a 0-d tensor of a fixed dtype consistently"))
    for label, val, users in prog.constants():
        if val.dim() != 0 or "aten.lift_fresh_copy" in users:
            continue
        findings.append(Finding(
            "recompile-hazard", WARN,
            f"a 0-d tensor is closed over and baked into the program "
            f"({label}): a capture replays the value it saw, so a change "
            "after the first capture is silently ignored",
            where=label,
            remediation="stage the scalar in the program's input buffers "
                        "(as TrainStep stages the step and the rate)"))
    findings.extend(static_arg_findings(prog.static_args))
    return findings


def static_arg_findings(static_args):
    """The static-argument half of recompile-hazard, callable on its own
    when the program did not trace."""
    findings = []
    for label, v in static_args.items():
        try:
            hash(v)
        except TypeError:
            findings.append(Finding(
                "recompile-hazard", HIGH,
                f"static argument {label} ({type(v).__name__}) is "
                "unhashable — it cannot key a capture cache, and hashable "
                "wrappers built per call capture every step",
                where=label,
                remediation="use a hashable static value (tuple instead of "
                            "list, frozen dataclass instead of dict)"))
            continue
        if _default_hash_identity(v):
            findings.append(Finding(
                "recompile-hazard", HIGH,
                f"static argument {label} ({type(v).__name__}) hashes by "
                "object identity — a fresh instance per call keys a NEW "
                "capture every step",
                where=label,
                remediation="define __hash__/__eq__ over the fields that "
                            "matter, or pass a stable singleton"))
    return findings


# ----------------------------------------------------------- collective-axis
def _declared_groups(mesh_axes):
    """The set of group names a declaration allows, or None."""
    if mesh_axes is None:
        return None
    items = (mesh_axes.values() if isinstance(mesh_axes, dict)
             else [mesh_axes] if isinstance(mesh_axes, str)
             else mesh_axes)
    names = set()
    for g in items:
        if isinstance(g, str):
            names.add(g)
        else:
            pg = getattr(g, "process_group", getattr(g, "pg", g))
            name = getattr(pg, "group_name", None)
            if name is None:
                try:
                    name = pg.group_name
                except Exception:
                    name = None
            if name is not None:
                names.add(name)
    return names


def _group_of(node):
    """The group name a collective node names (its ``group_name`` / ``tag``
    string argument, or the name of the ``ProcessGroup`` a c10d operator
    takes as a graph attribute), or None."""
    t = node.target
    schema = getattr(t, "_schema", None)
    if schema is not None:
        for i, arg in enumerate(schema.arguments):
            if arg.name not in ("group_name", "tag", "group",
                                "process_group"):
                continue
            v = (node.args[i] if i < len(node.args)
                 else node.kwargs.get(arg.name))
            if isinstance(v, str):
                return v
            if isinstance(v, torch.fx.Node) and v.op == "get_attr":
                try:
                    return torch._C._distributed_c10d.ProcessGroup.unbox(
                        getattr(v.graph.owning_module,
                                str(v.target))).group_name
                except Exception:
                    pass
    return next((a for a in node.args[::-1] if isinstance(a, str)), None)


def _live_group(name) -> bool:
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group

        _resolve_process_group(name)
        return True
    except Exception:
        return False


def rule_collective_axis(prog):
    """Collective nodes must name a group of the declared mesh (or, with
    none declared, a live group)."""
    declared = _declared_groups(prog.mesh_axes)
    findings = []
    for node, _stack, _scope in iter_eqns(prog.gm):
        name = op_name(node)
        if not (name.startswith("_c10d_functional.")
                or name.startswith("c10d.")
                or name.startswith("c10d_functional.")):
            continue
        if name.endswith("wait_tensor"):
            continue
        group = _group_of(node)
        if declared is not None:
            if group not in declared:
                findings.append(Finding(
                    "collective-axis", HIGH,
                    f"{name} runs over group {group!r}, which is not one of "
                    f"the declared mesh's groups {sorted(declared)} — this "
                    "program cannot run on that mesh",
                    where=source_of(node),
                    remediation="run the collective over the mesh's axis "
                                "group (distributed.mesh axis_group)"))
        elif group is not None and not _live_group(group):
            findings.append(Finding(
                "collective-axis", HIGH,
                f"{name} names group {group!r}, which no live process group "
                "carries",
                where=source_of(node),
                remediation="create the group before tracing, or run the "
                            "collective over an existing one"))
    return findings


RULES = {
    "donation-miss": rule_donation_miss,
    "dtype-upcast": rule_dtype_upcast,
    "host-sync": rule_host_sync,
    "constant-bloat": rule_constant_bloat,
    "recompile-hazard": rule_recompile_hazard,
    "collective-axis": rule_collective_axis,
}
