"""Multi-LoRA serving: a banked adapter store over one base model — the
counterpart of ``paddle_tpu/inference/adapters.py``.

Every adapter's low-rank factors live in fixed-shape banks, one pair of
tensors per target projection,

    A_bank[path]: [A_max + 1, in_features,  r_max]
    B_bank[path]: [A_max + 1, r_max, out_features]

padded per adapter (rank <= r_max, alpha / r folded into B at load time).
The paged step programs (``models/generation.py``) take an ``[S]`` int32
adapter index: each slot gathers its ``(A_i, B_i)`` rows and the target
projection's output gains ``(x @ A_i) @ B_i``. Bank row 0 is the identity
(all-zero factors): base requests ride the same program, and their output
is the base product with an exact zero added, bit-identical to a
scheduler without a registry.

A CUDA graph holds addresses, so where the JAX bank is functional (a new
array per load) this one is allocated once, on the model's device, when
the registry is built: ``register`` and ``unregister`` write rows in place
and synchronise before they return, so the first request routed to a new
row reads it whole. The step programs close over the bank tensors
themselves; a replay never re-enters Python.

The delta is a forward hook on each target sublayer, gated by a
``ContextVar`` that ``applied`` sets around a step program's body (its
eager first run, its capture and every CPU run): training, dense
``generate()`` and every other path see None and the hook does nothing.
The product is the JAX package's ``einsum`` pair as two ``torch.bmm`` over
the gathered rows, in the activation's dtype (the bank is cast down to it;
bf16 ``bmm`` accumulates in f32).

Lifecycle, under one re-entrant lock: ``register`` loads factors into a
free row and stamps a fresh uid seed (the prefix cache's digest-chain
seed, so KV prefilled under adapter A never matches adapter B, the base
model, or a later registration under the same name); ``unregister``
unmaps the name at once and frees the row when its refcount drains, so an
unload never races an in-flight request (admission holds a ref until the
sequence retires).

Fault site: ``lora.load`` (entry of ``register``, before any bank write).

Tensor parallelism: a registry over a rank's model shards holds its cut
of the bank. ``dims`` and ``register`` speak of the whole projection
(the factors are the same arrays on every rank); a column-parallel
target keeps the columns of B its weight holds (per head group for a
fused ``qkv_proj``, per half for ``gate_up``: the weight's layout,
``distributed.layout``), a row-parallel one the rows of A, and its
delta is added to the rank's partial product before the all-reduce
(``RowParallelLinear``'s ``_pre_reduce_hooks``). Under a lockstep
scheduler the leader's loads and frees are sent to the followers'
registries before they are written (``lockstep.LockstepLeader.
mirrored``), so every rank's bank rows change between the same two step
calls.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading

import numpy as np
import torch

__all__ = ["AdapterRegistry", "applied", "BASE_SLOT"]

# row 0 = identity (zero-delta) adapter: base-model traffic's bank row
BASE_SLOT = 0

# (bank, adapter index) while a LoRA-enabled step program's body runs;
# None on every other path, where the hooks below do nothing
_ACTIVE = contextvars.ContextVar("paddle_torch_lora_active", default=None)

_UIDS = itertools.count(1)      # registry ids (step-program cache keys)


@contextlib.contextmanager
def applied(bank, adapter_slots):
    """Arm the LoRA hooks for a model call: ``bank`` is
    ``AdapterRegistry.bank()``, ``adapter_slots`` the ``[S]`` int32 bank
    index on the bank's device."""
    token = _ACTIVE.set((bank, adapter_slots))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _delta(path, x, output):
    """``output`` plus each slot's ``(x @ A) @ B`` under ``applied``; None
    (no change) outside it."""
    active = _ACTIVE.get()
    if active is None:
        return None
    bank, aidx = active
    a = bank["a"][path].index_select(0, aidx)     # [S, in, r_max]
    b = bank["b"][path].index_select(0, aidx)     # [S, r_max, out]
    S = x.shape[0]
    d = torch.bmm(x.reshape(S, -1, x.shape[-1]), a.to(x.dtype))
    d = torch.bmm(d, b.to(x.dtype))
    return output + d.reshape(*output.shape[:-1], -1).to(output.dtype)


def _delta_hook(path):
    """Forward hook of one target projection: gather each slot's factors
    and add ``(x @ A) @ B`` to the output."""

    def hook(module, inputs, output):
        return _delta(path, inputs[0], output)

    return hook


def _pre_reduce_hook(path):
    """The same delta for a row-parallel target: added to the rank's
    partial product (its rows of A) before the all-reduce sums them."""

    def hook(module, x, partial):
        out = _delta(path, x, partial)
        return partial if out is None else out

    return hook


class _Removable:
    def __init__(self, hooks, key):
        self._hooks, self._key = hooks, key

    def remove(self):
        self._hooks.pop(self._key, None)


class _Slot:
    """One occupied bank row: name, digest seed, refcount, drain flag."""

    __slots__ = ("name", "seed", "refs", "draining")

    def __init__(self, name, seed):
        self.name = name
        self.seed = seed
        self.refs = 0
        self.draining = False


class AdapterRegistry:
    """Fixed-shape banked LoRA store and hook installer for one base model.

    ``targets`` are sublayer attribute names: every sublayer of
    ``model._decode_layer()`` whose path ends in one of them and that has
    a ``[in, out]`` weight becomes a LoRA target (for GPT: ``qkv_proj``
    and the FFN up-projection, ``gate_up`` or ``fc1``). The banks hold
    ``max_adapters`` loadable adapters (row 0 is the identity) of rank <=
    ``max_rank``, in ``dtype``, on the model's device."""

    def __init__(self, model, *, max_adapters=8, max_rank=8,
                 targets=("qkv_proj", "gate_up", "fc1"), dtype="float32",
                 faults=None):
        if max_adapters < 1:
            raise ValueError("max_adapters must be >= 1")
        if max_rank < 1:
            raise ValueError("max_rank must be >= 1")
        self._lock = threading.RLock()
        self._faults = faults           # FaultInjector | None (lora.load)
        self._rows = int(max_adapters) + 1          # + identity row 0
        self._r_max = int(max_rank)
        self._dtype = (getattr(torch, dtype) if isinstance(dtype, str)
                       else dtype)
        self.device = torch.device(model.device)
        self.uid = next(_UIDS)
        self._uid = itertools.count(1)
        from ..distributed.layout import layout_of

        root = model._decode_layer()
        self._dims = {}                  # path -> whole (in, out)
        self._pieces = {}                # path -> the weight's layout
        local = {}                       # path -> this rank's (in, out)
        self._hooks = []
        self._lockstep = None            # a LockstepLeader under TP
        for path, layer in torch.nn.Module.named_modules(root):
            if not path or path.split(".")[-1] not in targets:
                continue
            w = getattr(layer, "weight", None)
            if not isinstance(w, torch.Tensor) or w.dim() != 2:
                continue
            shape, pieces = layout_of(w)
            self._dims[path] = (int(shape[0]), int(shape[1]))
            self._pieces[path] = pieces
            local[path] = (int(w.shape[0]), int(w.shape[1]))
            pre = getattr(layer, "_pre_reduce_hooks", None)
            if pre is not None and getattr(layer, "group", None) is not None:
                key = object()
                pre[key] = _pre_reduce_hook(path)
                self._hooks.append(_Removable(pre, key))
            else:
                self._hooks.append(torch.nn.Module.register_forward_hook(
                    layer, _delta_hook(path)))
        if not self._dims:
            raise ValueError(
                f"no LoRA targets matched {targets!r} in the model")
        kw = dict(dtype=self._dtype, device=self.device)
        self._a = {p: torch.zeros((self._rows, i, self._r_max), **kw)
                   for p, (i, o) in local.items()}
        self._b = {p: torch.zeros((self._rows, self._r_max, o), **kw)
                   for p, (i, o) in local.items()}
        self._bank = {"a": self._a, "b": self._b}
        self._names = {}                             # name -> bank row
        self._slots = [None] * self._rows            # row -> _Slot | None

    # ------------------------------------------------------------ identity
    def signature(self):
        """Bank shape: (rows, r_max, number of target paths). Adapter
        contents and mix are program inputs and never appear here."""
        return ("lora", self._rows, self._r_max, len(self._dims))

    def bank(self):
        """{"a": {path: tensor}, "b": {path: tensor}}: the bank tensors
        themselves (fixed addresses for the registry's lifetime)."""
        return self._bank

    def bank_bytes(self):
        item = torch.empty(0, dtype=self._dtype).element_size()
        return sum(self._rows * (i * self._r_max + self._r_max * o) * item
                   for i, o in self._dims.values())

    def target_paths(self):
        return tuple(sorted(self._dims))

    def dims(self, path):
        """``(in_features, out_features)`` of a target path (of the whole
        projection under tensor parallelism)."""
        return self._dims[path]

    def _cut(self, path, a, b):
        """This rank's rows of A and columns of B: the weight's pieces."""
        a_loc = np.zeros((self._a[path].shape[1], a.shape[1]), np.float32)
        b_loc = np.zeros((b.shape[0], self._b[path].shape[2]), np.float32)
        for sl, off in self._pieces[path]:
            n0 = sl[0].stop - sl[0].start
            n1 = sl[1].stop - sl[1].start
            a_loc[sl[0]] = a[off[0]:off[0] + n0]
            b_loc[:, sl[1]] = b[:, off[1]:off[1] + n1]
        return a_loc, b_loc

    # ------------------------------------------------------------ lifecycle
    def _resolve(self, key):
        """A weights key (exact path or unique suffix) -> its target."""
        if key in self._dims:
            return key
        cands = [p for p in self._dims if p == key or p.endswith("." + key)]
        if len(cands) == 1:
            return cands[0]
        if not cands:
            raise ValueError(
                f"unknown LoRA target {key!r}; targets: "
                f"{sorted(self._dims)}")
        raise ValueError(
            f"ambiguous LoRA target {key!r} matches {sorted(cands)}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def register(self, name, weights, alpha=1.0):
        """Load an adapter into a free bank row; returns the row.

        ``weights`` maps target path (or unique suffix) to an ``(A, B)``
        pair, A ``[in, r]`` and B ``[r, out]`` (the whole projection's),
        r <= max_rank; ``alpha / r`` is folded into B here. Untouched
        targets keep zero factors. The rows are written in place and the
        device synchronised before this returns."""
        if self._faults is not None:
            self._faults.check("lora.load")
        if not weights:
            raise ValueError("empty adapter weights")
        resolved = {}
        for key, (a, b) in weights.items():
            path = self._resolve(key)
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            in_f, out_f = self._dims[path]
            if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"adapter {name!r} target {path!r}: A {a.shape} / "
                    f"B {b.shape} are not a rank factorization")
            r = a.shape[1]
            if r < 1 or r > self._r_max:
                raise ValueError(
                    f"adapter {name!r} target {path!r}: rank {r} outside "
                    f"1..{self._r_max}")
            if a.shape[0] != in_f or b.shape[1] != out_f:
                raise ValueError(
                    f"adapter {name!r} target {path!r}: expected A "
                    f"[{in_f}, r] / B [r, {out_f}], got {a.shape} / "
                    f"{b.shape}")
            resolved[path] = (a, b * (float(alpha) / r), r)
        with self._lock:
            if name in self._names:
                raise ValueError(f"adapter {name!r} already loaded")
            row = next((i for i in range(1, self._rows)
                        if self._slots[i] is None), None)
            if row is None:
                raise RuntimeError(
                    f"adapter bank full ({self._rows - 1} slots); "
                    "unregister one first or size max_adapters up")
            uid = next(self._uid)
            seed = f"lora:{name}:{uid}".encode()
            if self._lockstep is not None:
                self._lockstep.mirrored("adapters.register",
                                        (name, weights, alpha, row),
                                        lambda: self._write(resolved, row))
            else:
                self._write(resolved, row)
            self._slots[row] = _Slot(name, seed)
            self._names[name] = row
            return row

    def _write(self, resolved, row):
        with torch.no_grad():
            for path, (a, b, r) in resolved.items():
                a, b = self._cut(path, a, b)
                a_pad = np.zeros(self._a[path].shape[1:], np.float32)
                b_pad = np.zeros(self._b[path].shape[1:], np.float32)
                a_pad[:, :r] = a
                b_pad[:r, :] = b
                self._a[path][row].copy_(torch.from_numpy(a_pad))
                self._b[path][row].copy_(torch.from_numpy(b_pad))
        self._sync()

    def _mirror_register(self, name, weights, alpha, row):
        """A follower's side of the leader's ``register``: the same row."""
        with self._lock:
            if self._slots[row] is not None or name in self._names:
                raise RuntimeError(f"adapter row {row} / {name!r} out of "
                                   "step with the leader's registry")
            got = self.register(name, weights, alpha)
            if got != row:
                raise RuntimeError(f"adapter {name!r} took row {got}, the "
                                   f"leader's {row}")

    def _mirror_free(self, row):
        """A follower's side of the leader's free of ``row``."""
        with self._lock:
            slot = self._slots[row]
            if slot is not None:
                self._names.pop(slot.name, None)
            self._free_rows(row)

    def unregister(self, name):
        """Unmap ``name`` now; free its row when in-flight refs drain (new
        admissions fail at once, sequences holding the row keep valid
        factors until ``release``)."""
        with self._lock:
            row = self._names.pop(name, None)
            if row is None:
                raise ValueError(f"unknown adapter {name!r}")
            slot = self._slots[row]
            if slot.refs <= 0:
                self._free(row)
            else:
                slot.draining = True
            return row

    def _free(self, row):
        with self._lock:
            if self._lockstep is not None:
                self._lockstep.mirrored("adapters.free", (row,),
                                        lambda: self._free_rows(row))
            else:
                self._free_rows(row)

    def _free_rows(self, row):
        # zeroed: a freed row is an identity until reused
        with self._lock:
            with torch.no_grad():
                for path in self._a:
                    self._a[path][row].zero_()
                    self._b[path][row].zero_()
            self._sync()
            self._slots[row] = None

    # ------------------------------------------------------------ request path
    def has(self, name):
        with self._lock:
            return name in self._names

    def names(self):
        with self._lock:
            return sorted(self._names)

    def acquire(self, name):
        """Admission-side pin: (bank row, digest seed), the row's refcount
        bumped. ``name=None`` is the base model: row 0, empty seed, never
        refcounted."""
        if name is None:
            return BASE_SLOT, b""
        with self._lock:
            row = self._names.get(name)
            if row is None:
                raise ValueError(f"unknown adapter {name!r}")
            self._slots[row].refs += 1
            return row, self._slots[row].seed

    def release(self, row):
        """Retirement-side unpin; idempotent for row 0 and freed rows."""
        if row == BASE_SLOT:
            return
        with self._lock:
            slot = self._slots[row]
            if slot is None:
                return
            slot.refs = max(0, slot.refs - 1)
            if slot.draining and slot.refs == 0:
                self._free(row)

    # ---------------------------------------------------------- observability
    def stats(self):
        """{loaded, pinned, free} for the paddle_lora_adapters gauge."""
        with self._lock:
            occupied = [s for s in self._slots[1:] if s is not None]
            return {
                "loaded": len(occupied),
                "pinned": sum(1 for s in occupied if s.refs > 0),
                "free": (self._rows - 1) - len(occupied),
            }

    def close(self):
        """Detach the forward hooks."""
        with self._lock:
            hooks, self._hooks = self._hooks, []
        for h in hooks:
            h.remove()
