"""Thread lint: static lock-order + guarded-field analysis over host code —
the counterpart of ``paddle_tpu/analysis/threads.py``, with its AST model,
its five rules, their ids, severities and finding subjects.

The graph lint covers the *traced* programs; this pass covers the code
that LAUNCHES them — the serving batcher, the continuous scheduler's tick
loop, the checkpoint writer thread, the supervisor, the RLock'd KV pool,
the CUDA-graph capture of a step program. It is an AST analysis over the
port's own source in the style of Eraser's lockset discipline (Savage et
al., SOSP 1997) and RacerD's compositional ownership/guard inference
(Blackshear et al., OOPSLA 2018): no execution, no imports of the analyzed
modules, deterministic findings with file:line provenance.

Rules:

* ``lock-order-cycle`` (high) — a cycle in the interprocedural
  lock-acquisition graph: lock B is (possibly through method calls)
  acquired while A is held on one path and A while B on another. Two
  threads interleaving those paths deadlock.
* ``unguarded-write`` (high in runtime modules, warn elsewhere) — an
  attribute written outside ``__init__`` with an empty lockset, in a class
  that owns threads or locks, where the write either happens ON a worker
  thread (reachable from a ``threading.Thread(target=...)`` root through
  the call graph) or — for lock-owning classes in the runtime modules —
  anywhere (the strict discipline: shared-by-construction state is guarded
  or documented-atomic, full stop). Documented atomics (Queue, Event,
  deque, itertools.count, contextvars, the locks themselves) are exempt;
  mutating method calls (``.append``/``.pop``/``.update`` ...) on non-atomic
  attributes count as writes.
* ``blocking-under-lock`` (high in runtime modules, warn elsewhere) — a
  blocking call (``sleep``, argument-less ``join``/``wait``, ``.result()``,
  ``Queue.get`` without timeout, a device synchronisation, file/socket
  I/O) executed, directly or through a resolved method call, while a lock
  is held. Every other thread that touches that lock now waits on it. The
  device synchronisation is ``.synchronize()`` (``torch.cuda.synchronize``,
  an ``Event``'s or a ``Stream``'s), the counterpart of JAX's
  ``block_until_ready``; like JAX's lint, a host read of a device value
  (``.item()``, ``.cpu()``) is not counted.
* ``raw-clock`` (warn) — a direct ``time.time()``/``time.monotonic()`` call
  inside a class that defines an injectable clock (``self._clock`` /
  ``_now()``): the chaos tests steer those clocks by skewing, so a raw
  read is a test-determinism hole (and ``time.time()`` is not monotonic).
* ``non-daemon-thread`` (high in runtime modules, warn elsewhere) —
  ``threading.Thread(...)`` without ``daemon=True``: a leaked worker hangs
  interpreter shutdown.

Known limitations (by design — this is a linter, not a verifier): reads are
not raced against writes (write-side discipline only), dataflow through
containers/locals is not tracked, and cross-class calls resolve only when
the method name is unique among analyzed classes (ambiguity skips, never
guesses). The runtime lock witness (``analysis/lockwitness.py``) covers the
dynamic side the static pass cannot see.
"""
from __future__ import annotations

import ast
import fnmatch
import functools
import os

from .findings import HIGH, INFO, WARN, Allowlist, AllowlistEntry, Finding

__all__ = ["THREAD_RULES", "RUNTIME_MODULES", "BUILTIN_THREAD_ALLOWLIST",
           "analyze_threads", "lock_order_graph", "record_findings",
           "thread_lint_paths"]

THREAD_RULES = {
    "lock-order-cycle": "cycle in the interprocedural lock-acquisition "
                        "graph (potential deadlock)",
    "unguarded-write": "shared attribute written without holding a lock "
                       "(and not a documented atomic)",
    "blocking-under-lock": "blocking call (sleep/join/result/Queue.get/"
                           "I/O) while holding a lock",
    "raw-clock": "raw time.time()/time.monotonic() in a class with an "
                 "injectable clock",
    "non-daemon-thread": "threading.Thread(...) without daemon=True in "
                         "runtime code",
}

#: The threaded host-runtime modules where the strict discipline is
#: mandatory (findings are high severity here, warn elsewhere). Matched as
#: path suffixes against the analyzed file's os-normalized path. JAX's nine,
#: plus two modules only the port has, whose locks a serving thread takes:
#: ``jit/graphs.py`` (every step program's first run captures a CUDA graph
#: under ``_CAPTURE_LOCK``, and each ``StepRunner`` call holds its runner's
#: lock) and ``inference/lockstep.py`` (rank 0's scheduler thread sends each
#: tensor-parallel step-program call to the group under the leader's lock).
RUNTIME_MODULES = (
    "inference/serving.py",
    "inference/scheduler.py",
    "inference/kv_cache.py",
    "inference/prefix_cache.py",
    "inference/adapters.py",
    "inference/qos.py",
    "inference/resilience.py",
    "inference/faults.py",
    "framework/checkpoint.py",
    "jit/graphs.py",
    "inference/lockstep.py",
)

# constructors whose instances are documented-atomic under the GIL /
# internally locked — attributes holding them are exempt from the
# unguarded-write rule
_ATOMIC_CTORS = {
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "Event",
    "Semaphore", "BoundedSemaphore", "Barrier", "local", "ContextVar",
    "count", "deque",
}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "make_lock", "make_rlock",
               "make_module_lock", "make_module_rlock"}

# method names that mutate their receiver in place — a call
# ``self.attr.append(...)`` is a WRITE to ``attr`` for the guard rule
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft", "popitem",
    "remove", "clear", "update", "add", "discard", "setdefault", "sort",
}

_QUEUEISH = ("queue", "_q")     # base-attr name hints for Queue.get


def _is_queueish(name: str) -> bool:
    n = name.lower()
    return n in ("q", "_q") or "queue" in n


class _MethodInfo:
    __slots__ = ("cls", "name", "lineno",
                 "writes",       # [(attr, lockset, lineno, kind)]
                 "reads",        # {attr: {"locked": bool, "unlocked": bool}}
                 "calls",        # [(kind, name, lockset, lineno)]
                 "acquires",     # [(canonical_lock, lockset, lineno)]
                 "blocking",     # [(desc, lockset, lineno)]
                 "rawclock",     # [(expr, lineno)]
                 "threads",      # [(target_attr|None, daemon_ok, lineno)]
                 "acq_summary", "blk_summary")

    def __init__(self, cls, name, lineno):
        self.cls = cls
        self.name = name
        self.lineno = lineno
        self.writes = []
        self.reads = {}
        self.calls = []
        self.acquires = []
        self.blocking = []
        self.rawclock = []
        self.threads = []
        self.acq_summary = None
        self.blk_summary = None

    @property
    def qualname(self):
        return f"{self.cls.qualname}.{self.name}"


class _ClassInfo:
    __slots__ = ("module", "name", "path", "bases", "methods", "lock_attrs",
                 "atomic_attrs", "has_clock", "runtime")

    def __init__(self, module, name, path, bases, runtime):
        self.module = module        # module basename without .py
        self.name = name
        self.path = path            # repo-relative display path
        self.bases = bases          # base-class simple names
        self.methods = {}           # name -> _MethodInfo
        self.lock_attrs = set()
        self.atomic_attrs = set()
        self.has_clock = False
        self.runtime = runtime

    @property
    def qualname(self):
        return f"{self.module}.{self.name}"


# --------------------------------------------------------------- AST helpers
def _self_attr(node):
    """'attr' when node is ``self.attr``, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _ctor_name(call):
    """Simple constructor name of a Call: Queue() / queue.Queue() -> Queue."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_thread_ctor(call):
    f = call.func
    if isinstance(f, ast.Name) and f.id == "Thread":
        return True
    return isinstance(f, ast.Attribute) and f.attr == "Thread"


def _kwarg(call, name):
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def _blocking_desc(call):
    """Why this Call blocks, or None."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id == "open":
            return "file open()"
        if f.id in ("sleep",):
            return "sleep()"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    a = f.attr
    if a in ("sleep", "_sleep"):
        return "sleep"
    if a == "result":
        return ".result() on a future"
    if a == "synchronize":
        return ".synchronize() (device sync)"
    if a in ("recv", "accept", "connect", "select", "urlopen"):
        return f"socket/net .{a}()"
    if a == "join" and not call.args and not call.keywords:
        return ".join() without timeout"
    if a == "wait" and not call.args and not call.keywords:
        return ".wait() without timeout"
    if a == "get" and _kwarg(call, "timeout") is None and not call.args:
        base = f.value
        bname = (_self_attr(base) or
                 (base.id if isinstance(base, ast.Name) else
                  base.attr if isinstance(base, ast.Attribute) else ""))
        if bname and _is_queueish(bname):
            return "Queue.get() without timeout"
    return None


def _is_raw_clock(call):
    f = call.func
    return (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "time" and f.attr in ("time", "monotonic"))


class _MethodWalker:
    """Walks one method body tracking the held lockset through ``with``."""

    def __init__(self, cls: _ClassInfo, meth: _MethodInfo):
        self.cls = cls
        self.meth = meth

    def canon(self, attr):
        return f"{self.cls.qualname}.{attr}"

    def walk(self, stmts, held: frozenset):
        for st in stmts:
            self.stmt(st, held)

    def stmt(self, st, held):
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                self.expr(item.context_expr, held)
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in self.cls.lock_attrs:
                    name = self.canon(attr)
                    self.meth.acquires.append((name, held, st.lineno))
                    acquired.append(name)
            inner = held.union(acquired) if acquired else held
            self.walk(st.body, inner)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested closure: approximate with the def-site lockset (the
            # common pattern here is a helper called within the same block)
            self.walk(st.body, held)
        elif isinstance(st, ast.ClassDef):
            pass
        elif isinstance(st, (ast.If, ast.While)):
            self.expr(st.test, held)
            self.walk(st.body, held)
            self.walk(st.orelse, held)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self.expr(st.iter, held)
            self.expr(st.target, held)
            self.walk(st.body, held)
            self.walk(st.orelse, held)
        elif isinstance(st, (ast.Try,)):
            self.walk(st.body, held)
            for h in st.handlers:
                self.walk(h.body, held)
            self.walk(st.orelse, held)
            self.walk(st.finalbody, held)
        elif isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (st.targets if isinstance(st, ast.Assign)
                       else [st.target])
            for t in targets:
                self.write_target(t, held, st.lineno,
                                  aug=isinstance(st, ast.AugAssign))
            value = getattr(st, "value", None)
            if value is not None:
                self.expr(value, held)
            if isinstance(st, ast.AugAssign):   # aug target is also a read
                self.expr(st.target, held, store_ok=True)
        else:
            self.expr_stmt(st, held)

    def write_target(self, t, held, lineno, aug=False):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self.write_target(e, held, lineno, aug=aug)
            return
        attr = _self_attr(t)
        if attr is not None:
            self.meth.writes.append((attr, held, lineno, "assign"))
            return
        if isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                self.meth.writes.append((attr, held, lineno, "subscript"))
            else:
                self.expr(t.value, held)
            self.expr(t.slice, held)
        elif isinstance(t, (ast.Attribute,)):
            self.expr(t.value, held)    # obj.attr = ...: record obj read

    def expr_stmt(self, st, held):
        for node in ast.iter_child_nodes(st):
            if isinstance(node, ast.expr):
                self.expr(node, held)

    # ------------------------------------------------------------ expressions
    def expr(self, node, held, store_ok=False):
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self.call(n, held)
            elif isinstance(n, ast.Attribute):
                attr = _self_attr(n)
                if attr is not None and (isinstance(n.ctx, ast.Load)
                                         or store_ok):
                    st = self.meth.reads.setdefault(
                        attr, {"locked": False, "unlocked": False})
                    st["locked" if held else "unlocked"] = True

    def call(self, call, held):
        f = call.func
        # thread construction (daemon rule + roots)
        if _is_thread_ctor(call):
            target = _kwarg(call, "target")
            troot = _self_attr(target.value) if target is not None else None
            dkw = _kwarg(call, "daemon")
            daemon_ok = dkw is not None and not (
                isinstance(dkw.value, ast.Constant) and dkw.value.value is False)
            self.meth.threads.append((troot, daemon_ok, call.lineno))
        desc = _blocking_desc(call)
        if desc is not None:
            self.meth.blocking.append((desc, held, call.lineno))
        if _is_raw_clock(call):
            self.meth.rawclock.append((f"time.{f.attr}()", call.lineno))
        # mutating method call on a self attribute counts as a write
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr is not None:
                self.meth.writes.append((attr, held, call.lineno, "mutate"))
        # call-graph edges
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                self.meth.calls.append(("self", f.attr, held, call.lineno))
            else:
                self.meth.calls.append(("ext", f.attr, held, call.lineno))


# --------------------------------------------------------------- collection
_SKIPPED_DIRS = ("__pycache__", "_build", "csrc")


def thread_lint_paths(root=None):
    """Default file set: every .py under the paddle_tpu_torch package (the
    kernels' build outputs and CUDA sources are skipped)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIPPED_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def _is_runtime(relpath, runtime_modules):
    rp = relpath.replace(os.sep, "/")
    return any(rp.endswith(m) or fnmatch.fnmatch(rp, m)
               for m in runtime_modules)


class _Model:
    """Parsed view of the analyzed file set."""

    def __init__(self):
        self.classes = []               # [_ClassInfo]
        self.by_name = {}               # class simple name -> [_ClassInfo]
        self.methods_by_name = {}       # method name -> [_MethodInfo]
        self.module_threads = []        # [(relpath, runtime, daemon_ok, ln)]
        self.parse_errors = []          # [(relpath, error)]

    def add_class(self, ci):
        self.classes.append(ci)
        self.by_name.setdefault(ci.name, []).append(ci)
        for m in ci.methods.values():
            self.methods_by_name.setdefault(m.name, []).append(m)

    # --------------------------------------------------------- resolution
    def mro(self, ci):
        """Syntactic MRO approximation: the class then its bases depth-first
        (unique-name lookup; ambiguous or unknown bases stop the chain)."""
        out, seen, work = [], set(), [ci]
        while work:
            c = work.pop(0)
            if c.qualname in seen:
                continue
            seen.add(c.qualname)
            out.append(c)
            for b in c.bases:
                cands = self.by_name.get(b, [])
                if len(cands) == 1:
                    work.append(cands[0])
        return out

    def effective(self, ci):
        """name -> _MethodInfo honoring overrides (nearest in MRO wins)."""
        table = {}
        for c in self.mro(ci):
            for name, m in c.methods.items():
                table.setdefault(name, m)
        return table

    def lock_attrs(self, ci):
        return set().union(*(c.lock_attrs for c in self.mro(ci)))

    def atomic_attrs(self, ci):
        return set().union(*(c.atomic_attrs for c in self.mro(ci)))

    def has_clock(self, ci):
        return any(c.has_clock for c in self.mro(ci))

    def resolve_call(self, caller_cls, kind, name):
        """Best-effort callee resolution: self-calls in the caller's MRO,
        then (for both kinds) globally when the method name is unique."""
        if kind == "self":
            table = self.effective(caller_cls)
            if name in table:
                return table[name]
        cands = self.methods_by_name.get(name, [])
        if len(cands) == 1:
            return cands[0]
        return None


def _parse(paths, runtime_modules):
    model = _Model()
    common = os.path.commonpath([os.path.abspath(p) for p in paths]) \
        if len(paths) > 1 else os.path.dirname(os.path.abspath(paths[0]))
    for path in paths:
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, common)
        runtime = _is_runtime(ap, runtime_modules)
        try:
            with open(ap, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=ap)
        except (OSError, SyntaxError) as e:
            model.parse_errors.append((rel, repr(e)))
            continue
        modname = os.path.splitext(os.path.basename(ap))[0]
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                _collect_class(model, node, modname, rel, runtime)
            else:
                # module-level / free-function Thread ctors (daemon rule);
                # class bodies are covered by the per-method walk
                for n in ast.walk(node):
                    if isinstance(n, ast.Call) and _is_thread_ctor(n):
                        dkw = _kwarg(n, "daemon")
                        ok = dkw is not None and not (
                            isinstance(dkw.value, ast.Constant)
                            and dkw.value.value is False)
                        model.module_threads.append((rel, runtime, ok,
                                                     n.lineno))
    return model


def _collect_class(model, node, modname, rel, runtime):
    bases = []
    for b in node.bases:
        if isinstance(b, ast.Name):
            bases.append(b.id)
        elif isinstance(b, ast.Attribute):
            bases.append(b.attr)
    ci = _ClassInfo(modname, node.name, rel, bases, runtime)
    # first sweep: lock/atomic attribute classification + injectable clock
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name in ("_now",):
            ci.has_clock = True
        for n in ast.walk(item):
            if not isinstance(n, (ast.Assign, ast.AnnAssign)):
                continue
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            if isinstance(n.value, ast.Call):
                ctor = _ctor_name(n.value)
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if ctor in _LOCK_CTORS:
                        ci.lock_attrs.add(attr)
                    elif ctor in _ATOMIC_CTORS:
                        ci.atomic_attrs.add(attr)
            for t in targets:
                if _self_attr(t) in ("_clock", "clock"):
                    ci.has_clock = True
    # second sweep: per-method walk
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        meth = _MethodInfo(ci, item.name, item.lineno)
        _MethodWalker(ci, meth).walk(item.body, frozenset())
        ci.methods[item.name] = meth
    model.add_class(ci)


# ----------------------------------------------------- interprocedural passes
_MAX_SUMMARY = 64


def _summaries(model):
    """Fixed-point acquire/blocking summaries per method.

    acq_summary: {(lock, heldset_within_callee_frame)}; blk_summary:
    {(desc, heldset)} — call sites lift callee entries by their own held
    set, so 'sleep under a lock three calls down' still lands on the
    outermost holder."""
    methods = [m for ms in model.methods_by_name.values() for m in ms]
    for m in methods:
        m.acq_summary = {(lk, held) for lk, held, _ in m.acquires}
        m.blk_summary = {(d, held) for d, held, _ in m.blocking}
    for _ in range(6):      # call-chain depth cap; graphs here are shallow
        changed = False
        for m in methods:
            for kind, name, held, _ln in m.calls:
                callee = model.resolve_call(m.cls, kind, name)
                if callee is None or callee is m:
                    continue
                for lk, h in list(callee.acq_summary)[:_MAX_SUMMARY]:
                    e = (lk, held | h)
                    if e not in m.acq_summary and len(m.acq_summary) < _MAX_SUMMARY:
                        m.acq_summary.add(e)
                        changed = True
                for d, h in list(callee.blk_summary)[:_MAX_SUMMARY]:
                    # tag the blocking origin so a finding three calls up
                    # still names the method that actually blocks (and the
                    # allowlist can match on it)
                    if "(in " not in d:
                        d = f"{d} (in {callee.qualname})"
                    e = (d, held | h)
                    if e not in m.blk_summary and len(m.blk_summary) < _MAX_SUMMARY:
                        m.blk_summary.add(e)
                        changed = True
        if not changed:
            break


def _thread_roots(model):
    """(class, _MethodInfo) thread-entry points, resolved per concrete
    class so subclass overrides of a base's worker loop are reachable."""
    roots = []
    for ci in model.classes:
        table = model.effective(ci)
        for m in table.values():
            for target, _ok, _ln in m.threads:
                if target is not None and target in table:
                    roots.append((ci, table[target]))
    return roots


def _reachable(model):
    """Methods reachable from any thread root through resolved calls.
    Walked per (method, concrete-class) context so a subclass's override of
    a base's worker loop is reached through the inherited thread root."""
    seen_ctx, reachable = set(), set()
    work = [(m, ci) for ci, m in _thread_roots(model)]
    while work:
        m, ctx = work.pop()
        key = (id(m), ctx.qualname)
        if key in seen_ctx:
            continue
        seen_ctx.add(key)
        reachable.add(id(m))
        for kind, name, _held, _ln in m.calls:
            callee = model.resolve_call(ctx, kind, name)
            if callee is None:
                continue
            # self-calls stay in the concrete class's context (overrides
            # resolve there); ext-calls switch to the callee's own class
            nctx = ctx if kind == "self" else callee.cls
            work.append((callee, nctx))
    return reachable


def _class_has_roots(model, ci):
    table = model.effective(ci)
    return any(t is not None and t in table
               for m in table.values() for t, _ok, _ln in m.threads)


# ------------------------------------------------------------- lock graph
def _lock_edges(model):
    """{(held_lock, acquired_lock): 'path:line (Class.method)'} over the
    whole file set, interprocedural."""
    edges = {}
    for ms in model.methods_by_name.values():
        for m in ms:
            for lk, held in m.acq_summary:
                for h in held:
                    if h != lk and (h, lk) not in edges:
                        site = f"{m.cls.path} ({m.qualname})"
                        edges[(h, lk)] = site
    return edges


def _model_of(paths, runtime_modules):
    """The summarised model of ``paths``, parsed once while no file of
    them changes: the lint, ``lock_order_graph`` and the self-check's
    thread leg read the same tree."""
    stamps = []
    for p in paths:
        try:
            st = os.stat(p)
            stamps.append((os.path.abspath(p), st.st_mtime_ns, st.st_size))
        except OSError:
            stamps.append((os.path.abspath(p), None, None))
    return _summarised(tuple(stamps), tuple(runtime_modules))


@functools.lru_cache(maxsize=8)
def _summarised(stamps, runtime_modules):
    model = _parse([p for p, _m, _s in stamps], runtime_modules)
    _summaries(model)
    return model


def _cycles(edges):
    from .lockwitness import _find_cycles

    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    return _find_cycles(adj)


def lock_order_graph(root=None, paths=None, runtime_modules=RUNTIME_MODULES):
    """The statically-inferred lock-acquisition order: {(held, acquired):
    site}. The runtime witness checks its observed order against this
    (``LockWitness.check_static``)."""
    paths = paths if paths is not None else thread_lint_paths(root)
    return _lock_edges(_model_of(paths, runtime_modules))


# ------------------------------------------------------------ rule emission
def _sev(runtime):
    return HIGH if runtime else WARN


def _guarded_elsewhere(model, ci, attr):
    for c in model.mro(ci):
        for m in c.methods.values():
            st = m.reads.get(attr)
            if st and st["locked"]:
                return True
            for a, held, _ln, _k in m.writes:
                if a == attr and held:
                    return True
    return False


def _emit_findings(model):
    findings = []

    # lock-order-cycle --------------------------------------------------
    edges = _lock_edges(model)
    for cyc in _cycles(edges):
        path = " -> ".join(cyc)
        sites = []
        for a, b in zip(cyc, cyc[1:]):
            if (a, b) in edges:
                sites.append(f"{a}->{b} @ {edges[(a, b)]}")
        findings.append(Finding(
            "lock-order-cycle", HIGH,
            f"lock acquisition cycle {path}: two threads interleaving "
            f"these paths deadlock ({'; '.join(sites[:3])})",
            remediation="impose one global acquisition order (acquire the "
                        "cycle's locks in a fixed order everywhere), or "
                        "narrow one side to not call out while holding"))

    reachable = _reachable(model)

    for ci in model.classes:
        lock_attrs = model.lock_attrs(ci)
        atomic_attrs = model.atomic_attrs(ci)
        has_roots = _class_has_roots(model, ci)
        eligible = bool(lock_attrs) or has_roots
        for m in ci.methods.values():
            where = f"{ci.path}:{{ln}} ({m.qualname})"

            # unguarded-write -------------------------------------------
            if eligible and m.name != "__init__":
                on_thread = id(m) in reachable
                for attr, held, ln, kind in m.writes:
                    if held or attr in lock_attrs or attr in atomic_attrs:
                        continue
                    if attr.startswith("__"):
                        continue
                    strict = ci.runtime and bool(lock_attrs)
                    if not (on_thread or strict):
                        continue
                    why = ("written on a worker thread" if on_thread
                           else "written in a lock-owning runtime class")
                    extra = (" (the attribute IS guarded elsewhere — "
                             "inconsistent lockset)"
                             if _guarded_elsewhere(model, ci, attr) else "")
                    verb = ("mutated in place" if kind == "mutate"
                            else "written")
                    findings.append(Finding(
                        "unguarded-write", _sev(ci.runtime),
                        f"{ci.qualname}.{attr} {verb} with no lock held — "
                        f"{why}{extra}",
                        where=where.format(ln=ln),
                        remediation="hold the class lock around the write, "
                                    "use a documented atomic (Queue/Event/"
                                    "deque/itertools.count), or allowlist "
                                    "with the reason the race is benign"))

            # blocking-under-lock ---------------------------------------
            for desc, held, ln in m.blocking:
                if held:
                    findings.append(Finding(
                        "blocking-under-lock", _sev(ci.runtime),
                        f"{m.qualname} blocks ({desc}) while holding "
                        f"{', '.join(sorted(held))}",
                        where=where.format(ln=ln),
                        remediation="move the blocking call outside the "
                                    "critical section (copy state under "
                                    "the lock, block after release)"))
            # ... including through resolved calls (one finding per site)
            for kind, name, held, ln in m.calls:
                if not held:
                    continue
                callee = model.resolve_call(ci, kind, name)
                if callee is None:
                    continue
                blk = [d for d, h in callee.blk_summary]
                if blk:
                    findings.append(Finding(
                        "blocking-under-lock", _sev(ci.runtime),
                        f"{m.qualname} calls {callee.qualname} (which may "
                        f"block: {blk[0]}) while holding "
                        f"{', '.join(sorted(held))}",
                        where=where.format(ln=ln),
                        remediation="move the call outside the critical "
                                    "section or make the callee "
                                    "non-blocking"))

            # raw-clock --------------------------------------------------
            # the clock-defining method itself (the `else time.monotonic`
            # fallback in _now/monotonic) IS the injectable read-through
            if model.has_clock(ci) and m.name not in ("_now", "monotonic",
                                                      "_clock"):
                for expr, ln in m.rawclock:
                    findings.append(Finding(
                        "raw-clock", WARN,
                        f"{m.qualname} reads {expr} directly but the class "
                        f"has an injectable clock — skew-driven chaos tests "
                        f"cannot steer this timing",
                        where=where.format(ln=ln),
                        remediation="read through self._clock()/self._now() "
                                    "(the injector's skewable clock)"))

            # non-daemon-thread ------------------------------------------
            for _target, daemon_ok, ln in m.threads:
                if not daemon_ok:
                    findings.append(Finding(
                        "non-daemon-thread", _sev(ci.runtime),
                        f"{m.qualname} starts a Thread without daemon=True "
                        f"— a leaked worker hangs interpreter shutdown",
                        where=where.format(ln=ln),
                        remediation="pass daemon=True (and join explicitly "
                                    "on clean shutdown)"))

    # module-level Thread ctors outside class methods -------------------
    for rel, runtime, ok, ln in model.module_threads:
        if not ok:
            findings.append(Finding(
                "non-daemon-thread", _sev(runtime),
                "threading.Thread(...) without daemon=True",
                where=f"{rel}:{ln}",
                remediation="pass daemon=True"))

    for rel, err in model.parse_errors:
        findings.append(Finding(
            "rule-error", INFO, f"{rel} failed to parse: {err}"[:300]))
    return findings


# ----------------------------------------------------------------- allowlist
#: Intentional, justified exceptions on the port's own tree. Every entry is
#: a finding the analyzer is RIGHT about but the code is right to keep —
#: suppressions stay visible in Report.suppressed. JAX's six entries each
#: have their cause in the port too (the same classes were ported); the
#: last two are the port's own.
BUILTIN_THREAD_ALLOWLIST = Allowlist([
    AllowlistEntry(
        "unguarded-write", subject="thread-lint", contains="._busy",
        reason="single-writer worker-liveness flag: only the batcher thread "
               "writes it, readers (pending()/drain polls) tolerate a stale "
               "bool, and CPython guarantees torn-free bool stores"),
    AllowlistEntry(
        "blocking-under-lock", subject="thread-lint",
        contains="Supervisor.heal",
        reason="heal() sleeps its restart backoff under the supervisor lock "
               "BY DESIGN: the lock serializes concurrent healers so exactly "
               "one client pays the backoff and restarts the worker"),
    AllowlistEntry(
        "blocking-under-lock", subject="thread-lint", contains="TCPStore",
        reason="the store lock serializes the single-socket request/response "
               "protocol — a blocking read under it IS the framing contract "
               "(two interleaved writers would corrupt the wire format)"),
    AllowlistEntry(
        "unguarded-write", subject="thread-lint", contains="._last_launch",
        reason="tick-thread-only stash: the launch-timing hook writes it and "
               "the utilization tick fns read it back on the SAME scheduler "
               "loop thread within one launch — no second thread ever "
               "touches it, and taking _slot_lock inside the timing hook "
               "would risk lock re-entry from launch paths"),
    AllowlistEntry(
        "unguarded-write", subject="thread-lint",
        contains="InferenceServer.profile_dir",
        reason="lazy tmpdir resolution runs only while self._profile_lock "
               "is held: the /debug/profile handler acquires it "
               "non-blockingly (single-flight, 409 otherwise) before "
               "calling _capture_profile, so writers are serialized — the "
               "lint can't see the caller-held lock"),
    AllowlistEntry(
        "raw-clock", subject="thread-lint",
        contains="CheckpointManager._commit reads time.time()",
        reason="the manifest's wall_time stamp is informational only; "
               "checkpoint discovery orders by step number, never by clock "
               "(clock skew cannot resurrect old state)"),
    AllowlistEntry(
        "unguarded-write", subject="thread-lint",
        contains="graphs.StepRunner.",
        reason="a StepRunner's graphs, counters and FLOP counts are written "
               "only under its own `lock`, which every caller holds across "
               "fill / run / read (models/generation.py _run_step and "
               "generate(), analysis/hbm.py measure_body_peak) — the lint "
               "can't see the caller-held lock"),
    AllowlistEntry(
        "blocking-under-lock", subject="thread-lint",
        contains="AdapterRegistry",
        reason="a bank row is written in place on the card and the device "
               "synchronised before the registry publishes (or frees) the "
               "row: the registry lock also orders the leader's and the "
               "followers' row choice under tensor parallelism "
               "(LockstepLeader.mirrored), so the write and its sync stay "
               "inside it; it runs on adapter load and free, not per tick"),
])


# --------------------------------------------------------------- entry point
def analyze_threads(root=None, paths=None, *, runtime_modules=None,
                    allowlist=None, name="thread-lint",
                    max_findings_per_rule=32):
    """Run the thread lint over a file set (default: the whole
    ``paddle_tpu_torch`` package) and return a ``Report``.

    ``runtime_modules`` — path suffixes/globs where the strict discipline is
    high severity (default :data:`RUNTIME_MODULES`; pass ``("*",)`` to treat
    everything as runtime, e.g. for seeded-violation fixtures).
    ``allowlist`` defaults to :data:`BUILTIN_THREAD_ALLOWLIST`; suppressions
    require a reason and stay visible in ``Report.suppressed``."""
    from .core import Report

    runtime_modules = (RUNTIME_MODULES if runtime_modules is None
                       else tuple(runtime_modules))
    paths = paths if paths is not None else thread_lint_paths(root)
    if not paths:
        return Report(name, [], [], tuple(THREAD_RULES))
    findings = _emit_findings(_model_of(paths, runtime_modules))
    # deterministic order + per-rule cap
    order = {HIGH: 0, WARN: 1, INFO: 2}
    findings.sort(key=lambda f: (f.rule, order.get(f.severity, 3), f.where))
    capped, counts = [], {}
    for f in findings:
        n = counts.get(f.rule, 0)
        if n == max_findings_per_rule:
            capped.append(Finding(
                f.rule, f.severity,
                f"... further {f.rule} findings truncated "
                f"(cap {max_findings_per_rule})"))
        if n >= max_findings_per_rule:
            counts[f.rule] = n + 1
            continue
        counts[f.rule] = n + 1
        capped.append(f)
    for f in capped:
        f.subject = f.subject or name
    if allowlist is None:
        allowlist = BUILTIN_THREAD_ALLOWLIST
    kept, suppressed = allowlist.apply(capped, backend="")
    return Report(name, kept, suppressed, tuple(THREAD_RULES))


def record_findings(report, registry):
    """Count a report's findings (kept + suppressed) into
    ``paddle_analysis_findings_total{rule,severity}`` on a
    ``observability.metrics.MetricsRegistry`` — the same series the graph
    lint feeds, so thread- and comms-rule series ride the existing
    scrape."""
    counter = registry.counter(
        "paddle_analysis_findings_total",
        "Static-analysis findings by rule and severity",
        labels=("rule", "severity"))
    for f in report.findings:
        counter.labels(f.rule, f.severity).inc()
    for f, _e in report.suppressed:
        counter.labels(f.rule, "suppressed").inc()
    return counter
