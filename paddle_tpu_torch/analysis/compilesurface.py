"""Compile-surface lint: the deployment's program inventory as a contract —
the counterpart of ``paddle_tpu/analysis/compilesurface.py``.

Every decode entry point of ``paddle_tpu_torch/models/generation.py`` keeps
its captured step program under a ``cache_key`` tuple handed to
``self._runner_for(cache_key, ...)``. There are two such sites: dense
``generate()`` builds its key itself, and ``_step_runner`` builds the key of
every paged program from what its four callers pass (``generate_paged``,
``prefill_chunk``, ``decode_step``, ``verify_step``), so the extractor
follows that call and yields one schema per caller: ``dense``, ``paged``,
``prefill_chunk``, ``decode_step`` and ``verify_step``, JAX's five paths.
For a fixed serving configuration the set of keys the runtime can request
is finite and computable — unless a key component is fed by a raw
per-request value, in which case every novel value captures a new program
on live traffic.

1. **Key-schema extraction** — parse the source, find each tuple bound to
   the name handed to ``_runner_for`` (through ``_step_runner``'s
   parameters for its callers), and classify every component: ``literal``,
   ``shape`` (from an input's ``.shape`` / ``.dtype``), ``config`` (a
   server-pinned parameter or an identity such as the pool's uid),
   ``bucketed`` (passed through a function whose name holds "bucket") or
   ``request`` (a raw per-request scalar: the hazard). A ``cache_key +=``
   (the LoRA variant's ``adapter_key_part``) is recorded as the schema's
   extension.
2. **Closed inventory** — a ``ServingConfig`` evaluates the schemas into
   the exact keys a continuous-scheduler deployment requests; the port's
   keys also hold the pool's uid, the decode state's identity and the
   adapter bank's uid (a CUDA graph holds their addresses), which a config
   built by ``ServingConfig.from_predictor`` carries.
   ``inference/warmup.py``'s ``program_keys`` is this derivation.
3. **Rules**: ``manifest-incomplete`` (HIGH), ``unbounded-key`` (HIGH) and
   ``dead-bucket`` (WARN; HIGH in strict/fixture mode), as in JAX.

The pass is pure AST and arithmetic — no tracing — so it runs in
milliseconds: ``python -m paddle_tpu_torch.analysis --self-check`` gates it
(the ``compile_surface`` zoo entry), ``--surface PATH`` runs the seeded
fixtures, ``--manifest`` prints the derived inventory as JSON.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import json
import math
import os

from .core import Report
from .findings import HIGH, WARN, Allowlist, AllowlistEntry, Finding

__all__ = [
    "SURFACE_RULES", "BUILTIN_SURFACE_ALLOWLIST", "CompileSurfaceError",
    "KeyComponent", "KeySchema", "ServingConfig", "ProgramManifest",
    "extract_key_schemas", "default_serving_configs", "default_manifest",
    "analyze_compile_surface", "surface_fixture_reports", "zoo_cross_check",
]

GENERATION_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models", "generation.py")

SURFACE_RULES = {
    "manifest-incomplete":
        "a runtime-constructible step-program cache key is not covered by "
        "the declared ProgramManifest — it captures on live traffic after "
        "/readyz (the deploy gate)",
    "unbounded-key":
        "a cache-key component is fed by a raw request-derived scalar with "
        "no declared bucket set — the program inventory is open and every "
        "novel value captures a new program",
    "dead-bucket":
        "a manifest entry no analyzed serving configuration can request — "
        "warmup captures it, nothing ever runs it",
}

LITERAL = "literal"
SHAPE = "shape"
CONFIG = "config"
REQUEST = "request"
BUCKETED = "bucketed"

_RUNNER_CALL = "_runner_for"
_BOUNDING_MARKER = "bucket"

# decode-entry parameters that carry PER-REQUEST values at the API boundary
# (JAX :97-107): the whole-batch entry points take the client's budget and
# sampler knobs; the step programs launch only from the scheduler's tick
# loop with config-pinned widths and the sampler knobs in their buffers
REQUEST_SCALARS = {
    "generate": ("max_new_tokens", "temperature", "top_k"),
    "generate_paged": ("max_new_tokens", "temperature", "top_k"),
}

# key-tag -> the zoo programs that lint its captured form (analysis/zoo.py)
ZOO_FAMILIES = {
    "dense": ("gpt_decode_dense",),
    "paged": ("gpt_decode_paged",),
    "prefill_chunk": ("gpt_prefill_chunk", "gpt_prefill_prefix",
                      "gpt_prefill_chunk_tp", "gpt_prefill_chunk_lora"),
    "decode_step": ("gpt_decode_step", "gpt_decode_step_tp",
                    "gpt_decode_step_lora"),
    "verify_step": ("gpt_verify_step", "gpt_verify_step_tp",
                    "gpt_verify_step_lora"),
}


class CompileSurfaceError(RuntimeError):
    """Schema extraction or key derivation cannot proceed (source drift)."""


# ---------------------------------------------------------------- extraction
@dataclasses.dataclass(frozen=True)
class KeyComponent:
    """One element of a cache_key tuple with its provenance."""
    index: int
    source: str
    kind: str
    roots: tuple
    line: int


@dataclasses.dataclass(frozen=True)
class KeySchema:
    """The cache-key construction of one decode path. ``extension``: the
    sources of a ``cache_key +=`` that adds components when its condition
    holds (the LoRA variant's ``adapter_key_part``)."""
    path: str
    method: str
    line: int
    components: tuple
    extension: tuple = ()

    @property
    def arity(self) -> int:
        return len(self.components)

    def request_components(self):
        return [c for c in self.components if c.kind == REQUEST]


def _ordered_stmts(body):
    for stmt in body:
        yield stmt
        for attr in ("body", "orelse", "finalbody"):
            yield from _ordered_stmts(getattr(stmt, attr, []) or [])
        for handler in getattr(stmt, "handlers", []) or []:
            yield from _ordered_stmts(handler.body)


def _call_name(func):
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class _Scope:
    """One function's names: ``env`` (name -> (kind "expr" | "shape", the
    value node or shape source, the names before the assignment, its
    line)), its parameters, and, for a
    callee reached through a call, the caller's argument per parameter
    (``forward``) and the caller's scope. Each binding keeps the names as
    they stood before it, so a name is read as the code read it at that
    line (``inputs`` before ``inputs = {**inputs, ...}``)."""

    def at(self, env):
        """This scope with the names as they stood in ``env``."""
        return _Scope(self.method, env, self.params, self.forward,
                      self.caller)

    def __init__(self, method, env, params, forward=None, caller=None):
        self.method = method
        self.env = env
        self.params = params
        self.forward = forward or {}
        self.caller = caller


def _select(expr, key):
    """The element a constant subscript picks from a literal, or None."""
    if isinstance(expr, ast.Dict):
        for k, v in zip(expr.keys, expr.values):
            if isinstance(k, ast.Constant) and k.value == key:
                return v
    if isinstance(expr, (ast.Tuple, ast.List)) and isinstance(key, int):
        if -len(expr.elts) <= key < len(expr.elts):
            return expr.elts[key]
    return None


def _literal_of(expr, scope, depth=0):
    """(expression, scope) a name resolves to when it is bound to a literal
    (through assignments and forwarded parameters), else (expr, scope)."""
    while depth < 24 and isinstance(expr, ast.Name):
        depth += 1
        if expr.id in scope.env and scope.env[expr.id][0] == "expr":
            _kind, expr, before, _line = scope.env[expr.id]
            scope = scope.at(before)
        elif expr.id in scope.forward:
            expr, scope = scope.forward[expr.id], scope.caller
        else:
            break
    return expr, scope


def _pick(expr, scope, depth=0):
    """(expression, scope) a chain of constant subscripts into a literal
    denotes (``inputs["tables"][0]`` of a forwarded dict literal), else
    (expr, scope)."""
    if (depth < 24 and isinstance(expr, ast.Subscript)
            and isinstance(expr.slice, ast.Constant)):
        base, bscope = _pick(expr.value, scope, depth + 1)
        picked = _select(base, expr.slice.value)
        if picked is not None:
            return _pick(picked, bscope, depth + 1)
        return expr, scope
    return _literal_of(expr, scope)


def _roots(expr, scope, _depth=0, _open=frozenset()):
    """Provenance roots of an expression: (kind, name) pairs, kind one of
    'param' | 'shape' | 'self' | 'bucket' | 'global'. Purely syntactic:
    simple assignments, forwarded parameters and constant subscripts of
    literals are followed; everything else unions its children. ``_open``
    holds the names being resolved, so a name assigned from itself
    (``dtype = f(dtype)``) resolves once."""
    if _depth > 24 or expr is None:
        return set()
    if isinstance(expr, ast.Constant):
        return set()
    if isinstance(expr, ast.Name):
        here = (id(scope.env), expr.id)
        if expr.id in scope.env and here not in _open:
            kind, payload, before, _line = scope.env[expr.id]
            if kind == "shape":
                return {("shape", payload)}
            return _roots(payload, scope.at(before), _depth + 1,
                          _open | {here})
        if expr.id in scope.forward:
            return _roots(scope.forward[expr.id], scope.caller, _depth + 1,
                          _open)
        if expr.id in scope.params:
            return {("param", expr.id)}
        return {("global", expr.id)}
    if isinstance(expr, ast.Attribute):
        if expr.attr in ("shape", "dtype"):
            return {("shape", ast.unparse(expr.value))}
        if isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return {("self", expr.attr)}
        return _roots(expr.value, scope, _depth + 1, _open)
    if isinstance(expr, ast.Subscript):
        picked, pscope = _pick(expr, scope)
        if picked is not expr:
            return _roots(picked, pscope, _depth + 1, _open)
    if isinstance(expr, ast.Call):
        name = _call_name(expr.func)
        if _BOUNDING_MARKER in name:
            return {("bucket", name)}
        out = set()
        if isinstance(expr.func, ast.Attribute):
            out |= _roots(expr.func.value, scope, _depth + 1, _open)
        for a in list(expr.args) + [kw.value for kw in expr.keywords]:
            out |= _roots(a, scope, _depth + 1, _open)
        return out
    out = set()
    for child in ast.iter_child_nodes(expr):
        out |= _roots(child, scope, _depth + 1, _open)
    return out


def _component_kind(expr, roots, method):
    if isinstance(expr, ast.Constant):
        return LITERAL
    if any(k == "bucket" for k, _ in roots):
        return BUCKETED
    request = set(REQUEST_SCALARS.get(method, ()))
    if any(k == "param" and n in request for k, n in roots):
        return REQUEST
    if any(k == "shape" for k, _ in roots):
        return SHAPE
    return CONFIG


def _params_of(fn):
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    return [n for n in names if n != "self"]


def _scan(fn):
    """(env, tuples, runner sites) of one function: its assignments in
    order, the tuples bound to names, and each ``_runner_for`` call with
    the ``+=`` extensions of its key seen before it."""
    params = set(_params_of(fn))
    env, tuples, sites, ext = {}, {}, [], {}
    scope = _Scope(fn.name, env, params)
    for stmt in _ordered_stmts(fn.body):
        if isinstance(stmt, ast.AugAssign) and isinstance(stmt.target,
                                                          ast.Name):
            ext.setdefault(stmt.target.id, []).append(
                ast.unparse(stmt.value))
            continue
        if not isinstance(stmt, ast.Assign):
            continue
        tgt = stmt.targets[0] if len(stmt.targets) == 1 else None
        before = dict(env)
        if isinstance(tgt, ast.Name):
            env[tgt.id] = ("expr", stmt.value, before, stmt.lineno)
            if isinstance(stmt.value, ast.Tuple):
                tuples[tgt.id] = (stmt.value, stmt.lineno, before)
        elif isinstance(tgt, ast.Tuple) and all(
                isinstance(e, ast.Name) for e in tgt.elts):
            rhs = _roots(stmt.value, scope.at(before))
            is_shape = (isinstance(stmt.value, ast.Attribute)
                        and stmt.value.attr == "shape") or (
                            rhs and all(k == "shape" for k, _ in rhs))
            kind, payload = (("shape", ast.unparse(stmt.value)) if is_shape
                             else ("expr", stmt.value))
            for e in tgt.elts:
                env[e.id] = (kind, payload, before, stmt.lineno)
        if (isinstance(stmt.value, ast.Call)
                and _call_name(stmt.value.func) == _RUNNER_CALL
                and stmt.value.args):
            key_arg = stmt.value.args[0]
            if not isinstance(key_arg, ast.Name):
                raise CompileSurfaceError(
                    f"{fn.name}:{stmt.lineno}: {_RUNNER_CALL} key is not a "
                    "name bound to a tuple literal")
            if key_arg.id not in tuples:
                raise CompileSurfaceError(
                    f"{fn.name}:{stmt.lineno}: no tuple assignment to "
                    f"{key_arg.id!r} precedes the {_RUNNER_CALL} call")
            sites.append((tuples[key_arg.id],
                          tuple(ext.get(key_arg.id, ()))))
    # a site's names are read as they stood at its key's assignment
    return scope, sites


def _components(tup, scope, method, line):
    """KeyComponents of a key tuple in ``scope`` (``*name`` of a forwarded
    tuple literal expands into its elements)."""
    comps = []
    for el in tup.elts:
        items = [(el, scope)]
        if isinstance(el, ast.Starred):
            lit, lscope = _literal_of(el.value, scope)
            if isinstance(lit, (ast.Tuple, ast.List)):
                items = [(e, lscope) for e in lit.elts]
            else:
                items = [(el.value, scope)]
        for expr, sc in items:
            shown, shown_sc = expr, sc
            if (isinstance(expr, ast.Name) and expr.id in sc.forward
                    and expr.id not in sc.env):
                shown, shown_sc = sc.forward[expr.id], sc.caller
            roots = _roots(expr, sc)
            comps.append(KeyComponent(
                index=len(comps), source=ast.unparse(shown),
                kind=_component_kind(shown, roots, method),
                roots=tuple(sorted(f"{k}:{n}" for k, n in roots)),
                line=line))
    return tuple(comps)


def _env_at(env, line):
    """The bindings of ``env`` as they stood before ``line``: a binding
    made at or after it gives way to the one it replaced."""
    out = {}
    for name, binding in env.items():
        while binding is not None and binding[3] >= line:
            binding = binding[2].get(name)
        if binding is not None:
            out[name] = binding
    return out


def _bind_call(callee, call):
    """{callee parameter: caller argument expression} of one call."""
    names = _params_of(callee)
    out = {}
    for name, a in zip(names, call.args):
        out[name] = a
    for kw in call.keywords:
        if kw.arg is not None:
            out[kw.arg] = kw.value
    return out


def extract_key_schemas(source=None):
    """Parse ``source`` (default: the port's models/generation.py) and
    return {path: KeySchema}: one per ``_runner_for`` site whose key leads
    with a string literal, and, for a site whose key leads with a parameter
    (``_step_runner``'s ``kind``), one per caller that passes a literal
    there. Raises CompileSurfaceError when a site's key cannot be traced to
    a tuple literal."""
    path = source or GENERATION_SOURCE
    with open(path, "r") as fh:
        tree = ast.parse(fh.read(), filename=path)
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    by_name = {}
    for fn in fns:
        by_name.setdefault(fn.name, fn)
    scanned = {fn.name: _scan(fn) for fn in fns}
    schemas = {}

    def add(name, schema):
        if name in schemas:
            name = f"{name}@{schema.method}"
        schemas[name] = schema

    for fn in fns:
        fscope, sites = scanned[fn.name]
        for (tup, line, before), ext in sites:
            scope = fscope.at(before)
            head = tup.elts[0] if tup.elts else None
            if isinstance(head, ast.Constant) and isinstance(head.value, str):
                add(head.value, KeySchema(
                    head.value, fn.name, line,
                    _components(tup, scope, fn.name, line), ext))
                continue
            if isinstance(head, ast.Name) and head.id in scope.params:
                # a forwarder: one schema per caller passing a literal tag
                for caller in fns:
                    cscope, _ = scanned[caller.name]
                    for node in ast.walk(caller):
                        if not (isinstance(node, ast.Call)
                                and _call_name(node.func) == fn.name):
                            continue
                        bound = _bind_call(fn, node)
                        tag = bound.get(head.id)
                        if not (isinstance(tag, ast.Constant)
                                and isinstance(tag.value, str)):
                            continue
                        # the caller's names as they stood at the call
                        cenv = _env_at(cscope.env, node.lineno)
                        sub = _Scope(caller.name, scope.env, scope.params,
                                     forward=bound, caller=cscope.at(cenv))
                        add(tag.value, KeySchema(
                            tag.value, caller.name, node.lineno,
                            _components(tup, sub, caller.name,
                                        node.lineno), ext))
                continue
            name = "dense" if fn.name == "generate" else fn.name
            add(name, KeySchema(name, fn.name, line,
                                _components(tup, scope, fn.name, line), ext))
    return schemas


# ---------------------------------------------------------------- inventory
@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One deployment's serving shape — everything the continuous
    scheduler pins about its step programs. ``kv_signature`` is
    ``PagedKVCache.signature()``: (num_layers, num_kv_heads, head_dim,
    block_size, num_blocks, dtype[, ("tp", group id)]).

    JAX's fields, then three the port's keys hold because a captured
    program holds addresses: ``pool_uid`` (the pool's ``uid``),
    ``decode_state`` (``_state_for_key``'s identity of the decode state) and
    ``bank_uid`` (the adapter registry's ``uid``). They are None for a
    config planned ahead of a live pool, and left out of its JSON then, so
    a config's JSON is JAX's."""
    name: str = "continuous"
    slots: int = 8
    prefill_chunk: int = 16
    decode_steps: int = 4
    spec_k: int = 0
    eos_token_id: object = None
    max_seq_len: object = None
    kv_signature: tuple = (2, 4, 16, 128, 128, "torch.bfloat16")
    decode_kernel: object = "kernel"
    ids_dtype: str = "int64"
    paths: tuple = ("prefill_chunk", "decode_step")
    adapter_signature: object = None
    pool_uid: object = None
    decode_state: object = None
    bank_uid: object = None

    _PORT_ONLY = ("pool_uid", "decode_state", "bank_uid")

    @classmethod
    def from_predictor(cls, pred, name=None) -> "ServingConfig":
        """The config of a live continuous scheduler: its widths, its
        pool's signature and uid, its decode state and adapter bank."""
        kv = pred.kv_cache
        _, state_key = pred.model._state_for_key(kv.dtype)
        ad = getattr(pred, "adapters", None)
        return cls(
            name=name or getattr(pred, "_component", "continuous"),
            slots=int(pred.max_slots), prefill_chunk=int(pred.prefill_chunk),
            decode_steps=int(pred.decode_steps), spec_k=int(pred.spec_k),
            eos_token_id=pred.eos_token_id, max_seq_len=pred.max_seq_len,
            kv_signature=kv.signature(), decode_kernel=pred.decode_kernel,
            adapter_signature=None if ad is None else ad.signature(),
            pool_uid=kv.uid, decode_state=state_key,
            bank_uid=None if ad is None else ad.uid)

    @property
    def block_size(self) -> int:
        return int(self.kv_signature[3])

    @property
    def pool_tokens(self) -> int:
        return int(self.kv_signature[3]) * int(self.kv_signature[4])

    @property
    def seq_capacity(self) -> int:
        return int(self.max_seq_len) if self.max_seq_len else self.pool_tokens

    @property
    def table_width(self) -> int:
        # PagedKVCache.blocks_for: max(1, ceil(seq / block_size))
        return max(1, math.ceil(self.seq_capacity / self.block_size))

    @property
    def eos(self) -> int:
        return -1 if self.eos_token_id is None else int(self.eos_token_id)

    @property
    def adapter_part(self) -> tuple:
        """What ``adapter_key_part`` adds to a LoRA program's key."""
        if self.adapter_signature is None:
            return ()
        return (tuple(self.adapter_signature), ("bank", self.bank_uid))

    def active_paths(self):
        paths = list(self.paths)
        if self.spec_k > 0 and "verify_step" not in paths:
            paths.append("verify_step")
        return tuple(paths)

    def program_keys(self, schemas=None):
        """The closed set of cache keys this deployment can request.
        Raises CompileSurfaceError on schema drift."""
        keys, errors = _derive(self, schemas or extract_key_schemas())
        if errors:
            raise CompileSurfaceError("; ".join(f.message for f in errors))
        return keys

    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        for k in self._PORT_ONLY:
            if out[k] is None:
                del out[k]
        out["kv_signature"] = [list(x) if isinstance(x, tuple) else x
                               for x in self.kv_signature]
        out["paths"] = list(self.paths)
        if self.adapter_signature is not None:
            out["adapter_signature"] = list(self.adapter_signature)
        return out

    @classmethod
    def from_json(cls, obj) -> "ServingConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise CompileSurfaceError(f"unknown ServingConfig fields "
                                      f"{unknown}; known: {sorted(known)}")
        kw = dict(obj)
        if "kv_signature" in kw:
            kw["kv_signature"] = tuple(tuple(x) if isinstance(x, list) else x
                                       for x in kw["kv_signature"])
        if "paths" in kw:
            kw["paths"] = tuple(kw["paths"])
        if kw.get("adapter_signature") is not None:
            kw["adapter_signature"] = tuple(kw["adapter_signature"])
        return cls(**kw)


def _step_key(path, width):
    """The key ``_step_runner`` builds for ``path`` (``width``: the
    program's second shape entry)."""
    def build(c):
        eos = -1 if path == "verify_step" else c.eos
        return ((path, c.slots, width(c), c.table_width, c.kv_signature, eos,
                 c.ids_dtype, c.decode_kernel, ("pool", c.pool_uid),
                 c.decode_state) + c.adapter_part)
    return (10, build)


# per-path key builders; arity must match the extracted schema (drift gate)
_KEY_BUILDERS = {
    "prefill_chunk": _step_key("prefill_chunk", lambda c: c.prefill_chunk),
    "decode_step": _step_key("decode_step", lambda c: c.decode_steps),
    "verify_step": _step_key("verify_step", lambda c: c.spec_k + 1),
}


def _derive(config, schemas):
    """(keys, findings) for one config: the concrete cache keys its active
    paths request, plus manifest-incomplete findings for paths whose key
    set cannot be closed (no builder, schema drift)."""
    keys, findings = [], []
    for path in config.active_paths():
        schema = schemas.get(path)
        if schema is None:
            findings.append(Finding(
                "manifest-incomplete", HIGH,
                f"config {config.name!r} activates path {path!r} but no "
                f"cache-key schema for it was extracted from the source",
                subject=f"{config.name}:{path}",
                remediation="fix the paths= list or the source under "
                            "analysis"))
            continue
        builder = _KEY_BUILDERS.get(path)
        if builder is None:
            findings.append(Finding(
                "manifest-incomplete", HIGH,
                f"config {config.name!r} activates path {path!r} whose key "
                "set has no closed-form builder: its shapes are "
                "request-derived (whole-batch API) — keep it off "
                "warmup-gated deployments or declare buckets for it",
                subject=f"{config.name}:{path}",
                remediation="serve through the continuous scheduler paths "
                            "(prefill_chunk/decode_step/verify_step)"))
            continue
        arity, build = builder
        if schema.arity != arity:
            findings.append(Finding(
                "manifest-incomplete", HIGH,
                f"key-schema drift on {path!r}: source builds "
                f"{schema.arity} components, the derivation expects "
                f"{arity} — the derived inventory would be wrong",
                where=f"{os.path.basename(GENERATION_SOURCE)}:{schema.line}",
                subject=f"{config.name}:{path}",
                remediation="update analysis/compilesurface.py "
                            "_KEY_BUILDERS next to the cache_key change"))
            continue
        keys.append(build(config))
    return tuple(keys), findings


def _freeze(key):
    if isinstance(key, (list, tuple)):
        return tuple(_freeze(k) for k in key)
    return key


@dataclasses.dataclass(frozen=True)
class ProgramManifest:
    """The declared program inventory: the cache keys a deployment commits
    to capturing ahead (``inference.warmup``) and to never exceeding."""
    name: str = "manifest"
    programs: tuple = ()

    @classmethod
    def from_configs(cls, configs, schemas=None,
                     name="derived") -> "ProgramManifest":
        schemas = schemas or extract_key_schemas()
        seen, out = set(), []
        for cfg in configs:
            for key in _derive(cfg, schemas)[0]:
                if key not in seen:
                    seen.add(key)
                    out.append(key)
        return cls(name=name, programs=tuple(out))

    def covers(self, key) -> bool:
        return _freeze(key) in {_freeze(p) for p in self.programs}

    def __contains__(self, key) -> bool:
        return self.covers(key)

    def to_json(self) -> dict:
        return {"name": self.name,
                "programs": [list(p) for p in self.programs]}

    @classmethod
    def from_json(cls, obj) -> "ProgramManifest":
        return cls(name=obj.get("name", "manifest"),
                   programs=tuple(_freeze(p) for p in obj["programs"]))


@functools.lru_cache(maxsize=1)
def default_serving_configs():
    """The deployment shapes the shipped serving defaults produce, at the
    zoo smoke pool geometry (analysis/zoo.py ``_continuous_smoke``): the
    continuous scheduler's default knobs over the 2-layer GPT smoke pool,
    with and without speculative decoding, plus the multi-LoRA shape of the
    zoo's adapter entries (4 adapters + identity, rank 8, 4 target
    projections)."""
    base = ServingConfig(name="continuous-default")
    return (base,
            dataclasses.replace(base, name="continuous-spec", spec_k=4),
            dataclasses.replace(base, name="continuous-lora",
                                adapter_signature=("lora", 5, 8, 4)))


def default_manifest() -> ProgramManifest:
    return ProgramManifest.from_configs(default_serving_configs(),
                                        name="default-serving")


# --------------------------------------------------------------- the rules
# JAX's paged pins (:517-532) where the port's generate_paged has the same
# key: its budget n = int(max_new_tokens) is per-request at the API
# boundary, but the fixed-batch serving path passes the server-wide cap.
# The port's sampler knobs are buffer inputs, not key components, so JAX's
# greedy / temperature / top_k pins have nothing to suppress here.
_PAGED_PIN = ("the fixed-batch serving path pins this scalar: _run_batch "
              "passes the server-wide max_new_tokens cap and "
              "supports_sampler_knobs=False rejects per-request sampler "
              "headers (inference/serving.py), so one value per deployment "
              "reaches generate_paged")
BUILTIN_SURFACE_ALLOWLIST = Allowlist([
    AllowlistEntry("unbounded-key", subject="paged:n", reason=_PAGED_PIN),
])


def _key_subject(key) -> str:
    head = key[:3] if isinstance(key[0], str) else ("dense",) + tuple(key[:2])
    return ":".join(str(k) for k in head)


def analyze_compile_surface(configs=None, manifest=None, *, source=None,
                            allowlist=None, strict=False,
                            name="compile-surface") -> Report:
    """Run the compile-surface lint; returns the shared Report type.

    configs: ServingConfigs to derive inventories for (default: the
        shipped ``default_serving_configs()``, none when ``source`` points
        at a fixture). manifest: the declared ProgramManifest (default:
        derived from ``configs``). strict: fixture mode — dead-bucket
        escalates to HIGH."""
    schemas = extract_key_schemas(source)
    rel = source or os.path.join("paddle_tpu_torch", "models",
                                 "generation.py")
    if configs is None:
        configs = () if source is not None else default_serving_configs()

    findings = []
    for schema in schemas.values():
        for comp in schema.request_components():
            roots = [r.split(":", 1)[1] for r in comp.roots
                     if r.startswith("param:")]
            findings.append(Finding(
                "unbounded-key", HIGH,
                f"{schema.path} cache key [{comp.index}] `{comp.source}` is "
                f"fed by per-request scalar(s) {roots or comp.source} with "
                "no declared bucket set — every distinct value captures a "
                "new whole program",
                where=f"{rel}:{comp.line}",
                subject=f"{schema.path}:{comp.source}",
                remediation="bucket the component to a declared set "
                            "(models/generation.py bucket_new_tokens) or "
                            "pin it at the serving layer"))

    derived = {}
    for cfg in configs:
        keys, errs = _derive(cfg, schemas)
        findings.extend(errs)
        for k in keys:
            derived.setdefault(k, []).append(cfg.name)

    if manifest is None:
        manifest = ProgramManifest(name="derived", programs=tuple(derived))

    for key, names in derived.items():
        if not manifest.covers(key):
            findings.append(Finding(
                "manifest-incomplete", HIGH,
                f"runtime-constructible key {key} (config(s) "
                f"{', '.join(names)}) is not covered by manifest "
                f"{manifest.name!r} — it captures on live traffic after "
                "/readyz",
                where=rel, subject=_key_subject(key),
                remediation="add the program to the manifest (python -m "
                            "paddle_tpu_torch.analysis --manifest prints "
                            "the derived inventory) or drop the config "
                            "shape"))
    frozen = {_freeze(k) for k in derived}
    for key in manifest.programs:
        if _freeze(key) not in frozen:
            findings.append(Finding(
                "dead-bucket", HIGH if strict else WARN,
                f"manifest program {key} is not derivable from any "
                "analyzed config — warmup captures it, nothing requests it",
                where=manifest.name, subject=_key_subject(key),
                remediation="drop the stale bucket, or add the config "
                            "that needs it to the analyzed set"))

    al = allowlist if allowlist is not None else BUILTIN_SURFACE_ALLOWLIST
    kept, suppressed = al.apply(findings, backend="")
    return Report(name, kept, suppressed, tuple(SURFACE_RULES))


# ------------------------------------------------------------ fixture mode
def surface_fixture_reports(path):
    """Seeded-violation mode for ``--surface PATH``: a ``.py`` file is a
    generation-like source analyzed in pure AST mode; a ``.json`` file is
    {"configs": [...], "manifest": {...}, "source"?: "rel.py"}; a
    directory runs every such fixture inside it. Everything is strict."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.endswith((".py", ".json")))
        out = []
        for n in names:
            out.extend(surface_fixture_reports(os.path.join(path, n)))
        return out
    label = f"compile-surface[{os.path.basename(path)}]"
    if path.endswith(".json"):
        with open(path, "r") as fh:
            spec = json.load(fh)
        configs = tuple(ServingConfig.from_json(c)
                        for c in spec.get("configs", []))
        manifest = (ProgramManifest.from_json(spec["manifest"])
                    if "manifest" in spec else None)
        source = spec.get("source")
        if source is not None and not os.path.isabs(source):
            source = os.path.join(os.path.dirname(path), source)
        return [analyze_compile_surface(
            configs, manifest, source=source, strict=True,
            allowlist=Allowlist([]), name=label)]
    return [analyze_compile_surface(
        (), None, source=path, strict=True, allowlist=Allowlist([]),
        name=label)]


# ------------------------------------------------------------- zoo contract
def zoo_cross_check(schemas=None):
    """Verify ZOO_FAMILIES against the live zoo registry: every extracted
    key schema must have at least one registered zoo program, and every
    family's programs must be registered. Returns {path: (programs,)};
    raises CompileSurfaceError on a gap."""
    from .zoo import ZOO_PROGRAMS

    schemas = schemas or extract_key_schemas()
    registered = set(ZOO_PROGRAMS)
    out = {}
    for path in schemas:
        family = ZOO_FAMILIES.get(path)
        if not family:
            raise CompileSurfaceError(
                f"decode path {path!r} has no zoo lint family — register "
                "its program in analysis/zoo.py and map it in "
                "ZOO_FAMILIES")
        missing = [p for p in family if p not in registered]
        if missing:
            raise CompileSurfaceError(
                f"ZOO_FAMILIES[{path!r}] names unregistered zoo "
                f"program(s) {missing}")
        out[path] = family
    return out
