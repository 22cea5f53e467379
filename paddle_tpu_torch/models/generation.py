"""Autoregressive decoding — the counterpart of
``paddle_tpu/models/generation.py``: dense ``generate()`` (:284-406, with
``bucket_new_tokens`` :77), whole-batch ``generate_paged()`` (:433-537), the
continuous-batching step programs ``prefill_chunk`` (:565) and
``decode_step`` (:682), speculative ``verify_step`` (:797-974) and
``generate_speculative`` (:976), all with ``_make_slot_sampler``'s law
(:162-193).

The JAX package compiles one program per cache key and replays it
(``_runner_for``, :195-220). The port does the same with CUDA graphs
(``jit/graphs.py``): ``prefill_chunk``, ``decode_step``, ``verify_step``,
dense ``generate()`` and ``generate_paged`` are bodies that read static
device buffers —
positions, write targets, validity, the sampler and the loop over
``steps`` are computed on the device — captured once per key on CUDA and
replayed for every later call; on the CPU the same bodies run on the same
buffers every call. A call fills its inputs with one host-to-device copy
and reads its result back with one copy. ``chunk_logits`` runs the same
forward eagerly, one launch per kernel.
Every paged forward builds its pool write targets on the device at a
fixed length (``paged_write_slots``), the rows it drops aimed at the
pool's scratch slot.

The keys mirror JAX's (shapes, pool signature, eos, ids dtype, decode
kernel) and add what a graph holds by address: the pool
(``PagedKVCache.uid``; a pool's runners go when it does) and the decode
state (the dict of cast parameters, or the parameters' addresses).
Sampler knobs are inputs, not key parts: the sort and the draw always run
and ``torch.where(temps > 0, ...)`` picks, so greedy and sampled traffic
share one program. The pools of a ``PagedKVCache`` are updated IN PLACE
(no donation, no commit of returned pools); dense ``generate()`` keeps its
caches in its runner, at most ``_DENSE_RUNNERS`` of them per model, and at
most ``_PAGED_RUNNERS`` ``generate_paged`` graphs are kept.

Sampling per slot: temperature <= 0 is greedy argmax; otherwise softmax
sampling at that temperature with top-k truncation (top_k <= 0: none), by
inverse CDF at uniforms that a ``torch.Generator`` seeded per call draws
on the host, so one seed gives the same draws on every device.
"""
from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from ..analysis.lockwitness import make_module_lock, make_module_rlock
from ..framework import make_generator
from ..jit.graphs import StepRunner, poisoned
from ..observability.device import cost_flops
from ..ops.paged_attention import paged_write_slots
from .steps import DenseStep, PagedStep

__all__ = ["GenerationMixin", "bucket_new_tokens", "STEP_ARG_LABELS",
           "STEP_INPUT_LABELS", "step_arg_labels"]

_F32_MIN = torch.finfo(torch.float32).min
# one cold build (runner construction) at a time, as JAX traces one key at
# a time; lookups of built runners take no lock
_TRACE_LOCK = make_module_lock("generation._TRACE_LOCK")
# functional_call's parameter swap, and every read of the parameters
# that must not see a swap in progress (the decode state's cast cache)
_SWAP_LOCK = make_module_rlock("generation._SWAP_LOCK")
# dense generate() runners kept per model, least recently used dropped
# first: unlike a compiled JAX program, each holds its own caches
# ([B, Hkv, P + bucket, D] per layer, K and V), 0.5 GB at B 8, P 512,
# bucket 128 for GPT-350M in bf16
_DENSE_RUNNERS = 4
# generate_paged runners kept per model, least recently used dropped first:
# a whole-batch server makes one per (batch, prompt bucket) it meets
_PAGED_RUNNERS = 16


# The step programs' arguments under JAX's labels (JAX ``generation.py``
# :56-75), the names the comms lint reports input layouts by, so the two
# packages' surfaces compare label by label. "state" is the decode layer's
# parameters, "k_pages" / "v_pages" the pools; the rest are runner inputs.
STEP_ARG_LABELS = {
    "prefill_chunk": ("state", "chunk", "offsets", "chunk_lens", "tables",
                      "temperatures", "top_ks", "k_pages", "v_pages",
                      "rng_key"),
    "decode_step": ("state", "tokens", "lengths", "active", "max_lens",
                    "tables", "temperatures", "top_ks", "k_pages",
                    "v_pages", "rng_key"),
    "verify_step": ("state", "chunk", "offsets", "draft_lens", "active",
                    "max_lens", "tables", "temperatures", "top_ks",
                    "k_pages", "v_pages", "rng_key"),
}
# The runner input each label names. JAX passes a PRNG key where the port
# passes the uniforms it drew on the host from the call's seed: "u", and in
# verify_step its two draws, "u_accept" and "u_next".
STEP_INPUT_LABELS = {
    "prefill_chunk": {"ids": "chunk", "offsets": "offsets",
                      "lens": "chunk_lens", "tables": "tables",
                      "temps": "temperatures", "top_ks": "top_ks",
                      "u": "rng_key", "aidx": "adapter_slots"},
    "decode_step": {"tokens": "tokens", "lengths": "lengths",
                    "active": "active", "max_lens": "max_lens",
                    "tables": "tables", "temps": "temperatures",
                    "top_ks": "top_ks", "u": "rng_key",
                    "aidx": "adapter_slots"},
    "verify_step": {"ids": "chunk", "offsets": "offsets",
                    "draft_lens": "draft_lens", "active": "active",
                    "max_lens": "max_lens", "tables": "tables",
                    "temps": "temperatures", "top_ks": "top_ks",
                    "u_accept": "rng_key", "u_next": "rng_key",
                    "aidx": "adapter_slots"},
}


def step_arg_labels(kind, *, adapters=False):
    """Argument labels for one step program path (``STEP_ARG_LABELS``); a
    LoRA program adds "adapter_slots" and "bank" before "rng_key"."""
    base = STEP_ARG_LABELS[kind]
    if not adapters:
        return base
    return base[:-1] + ("adapter_slots", "bank", "rng_key")


def bucket_new_tokens(max_new_tokens):
    """The dense path's declared ``max_new_tokens`` bucket: the next power
    of two (JAX ``generation.py:77-91``). ``generate()`` sizes its caches at
    prompt + bucket, as the JAX program does."""
    n = int(max_new_tokens)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _cut_logits(lg32, temps, top_ks):
    """The sampler's law as logits: ``lg32`` [S, ..., V] over the
    temperature (1 where greedy), entries below the top_k-th set to the f32
    minimum (top_k <= 0: none); ``temps`` and ``top_ks`` [S] broadcast over
    the axes between."""
    extra = (1,) * (lg32.dim() - 1)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    scaled = lg32 / safe_t.reshape(-1, *extra)
    vocab = scaled.shape[-1]
    k_idx = (top_ks.clamp(1, vocab) - 1).long().reshape(-1, *extra)
    kth = scaled.sort(dim=-1, descending=True).values.gather(
        -1, k_idx.expand(*scaled.shape[:-1], 1))
    return torch.where((top_ks > 0).reshape(-1, *extra) & (scaled < kth),
                       torch.full_like(scaled, _F32_MIN), scaled)


def _inverse_cdf(probs, u):
    """One index drawn from each row of ``probs`` [..., V] at the uniforms
    ``u`` [...] in [0, 1): the first index whose cumulative probability
    passes u times the row's total. In f64, so an index of zero
    probability (a top-k cut) is never drawn."""
    cdf = probs.double().cumsum(dim=-1)
    target = (u.double() * cdf[..., -1]).unsqueeze(-1)
    idx = torch.searchsorted(cdf, target, right=True).squeeze(-1)
    return idx.clamp(max=probs.shape[-1] - 1)


def _drop_runners(model_ref, tag):
    """Forget the runners whose key holds ``tag`` (a pool that died, a
    cast state that was rebuilt)."""
    model = model_ref()
    cache = None if model is None else model.__dict__.get("_generate_cache")
    for key in list(cache or ()):
        if tag in key:
            cache.pop(key, None)


def adapter_key_part(adapters):
    """What a LoRA step program's cache key adds: the bank's shape and the
    registry holding the bank tensors the program reads."""
    return (adapters.signature(), ("bank", adapters.uid))


def _with_adapters(body, bank):
    """``body`` run under ``applied(bank, aidx)``: the LoRA hooks fire in
    the eager first run, the capture and every CPU run alike."""
    from ..inference.adapters import applied

    def run(inp, out):
        with applied(bank, inp["aidx"]):
            body(inp, out)
    return run


class GenerationMixin:
    """Hooks a model provides: ``_decode_layer()`` (the module taking
    ``(ids, k_caches, v_caches, step, decode_kernel)`` and returning
    logits, where the caches are paged pools under a ``PagedStep`` and
    dense caches under a ``DenseStep``), ``_decode_cache_spec()`` ->
    (layers, kv heads, head dim), ``_decode_validate(prompt_len,
    max_new_tokens)`` (raises on a request the model cannot serve; called
    by ``generate``, ``generate_paged``, the continuous scheduler's
    admission and ``speculative_generate``, as in JAX) and ``device``."""

    # ------------------------------------------------------------ state cast
    def _decode_state(self, dtype, params=None):
        """The decode layer's parameters cast to ``dtype`` (f32 tensors
        only), cached until a parameter changes; None when no cast is
        needed (the parameters run as they are). ``params``: the layer's
        named parameters, when the caller has them. Under ``_SWAP_LOCK``:
        several schedulers (a fleet's replicas) build programs at once, and
        none may read the parameters while another's forward has swapped
        them, nor cast twice (a second cast drops the programs captured
        over the first)."""
        with _SWAP_LOCK:
            if params is None:
                params = dict(self._decode_layer().named_parameters())
            if all(p.dtype == dtype or p.dtype != torch.float32
                   for p in params.values()):
                return None
            key = (dtype,
                   tuple((id(p), p._version) for p in params.values()))
            cached = getattr(self, "_decode_state_cache", None)
            if cached is not None and cached[0] == key:
                return cached[1]
            with torch.no_grad():
                cast = {n: (p.to(dtype) if p.dtype == torch.float32 else p)
                        for n, p in params.items()}
            if cached is not None:      # programs captured over the old cast
                _drop_runners(weakref.ref(self), ("cast", id(cached[1])))
            self._decode_state_cache = (key, cast)
            return cast

    def _state_for_key(self, dtype):
        """(state, key part): the decode state and what a captured program
        holds of it by address — the cast dict (kept alive by the runner,
        rebuilt when a parameter changes) or the parameters' addresses
        (updates in place are seen by a replay). ``dtype`` None: the
        parameters as they are."""
        with _SWAP_LOCK:
            params = dict(self._decode_layer().named_parameters())
            state = None if dtype is None else self._decode_state(dtype,
                                                                  params)
        if state is not None:
            return state, ("cast", id(state))
        return None, ("params", tuple(p.data_ptr() for p in params.values()))

    def _decode_call(self, state, ids, k_caches, v_caches, step,
                     decode_kernel):
        """One model forward over the paged pools or dense caches ->
        logits [B, S, V]."""
        layer = self._decode_layer()
        args = (ids, k_caches, v_caches, step, decode_kernel)
        if state is None:
            return self._whole_vocab(layer(*args))
        # functional_call swaps the module's parameters for the cast state
        # and back: two threads forwarding one model at once (a fleet's
        # replicas, or a FLOP count beside a capture) would restore each
        # other's swap and leave the cast in the model
        with _SWAP_LOCK:
            return self._whole_vocab(
                torch.func.functional_call(layer, state, args))

    # ------------------------------------------------ tensor parallelism
    def _tp(self):
        """The model's tensor-parallel group, or None."""
        return getattr(self, "tp_group", None)

    def _whole_vocab(self, logits):
        """Under tensor parallelism the forward gives this rank's vocab
        columns: gather them, so every rank samples from the same logits
        (and, from the same uniforms, picks the same token)."""
        g = self._tp()
        if g is None:
            return logits
        from ..distributed.collective import _gather_cat

        return _gather_cat(logits, logits.dim() - 1, g)

    def _local_kv_heads(self):
        """The kv heads of this rank's caches."""
        _, kv_heads, _ = self._decode_cache_spec()
        g = self._tp()
        return kv_heads if g is None else kv_heads // g.nranks

    def _check_pool(self, kv_cache):
        """A pool must hold this rank's kv heads: one built over the same
        tensor-parallel group (``PagedKVCache(tp_group=)``)."""
        if kv_cache.local_kv_heads != self._local_kv_heads():
            raise ValueError(
                f"the pool holds {kv_cache.local_kv_heads} kv heads a rank, "
                f"the model {self._local_kv_heads()}: build it over the "
                f"model's tensor-parallel group")

    @staticmethod
    def _device_step(offsets, S, tables, valid, block_size, scratch_slot):
        """Per-forward context, built on the device with no host
        synchronisation (so a graph can capture it): ``offsets`` [B] int64,
        ``tables`` [B, NB] int32, ``valid`` [B, S]; every row gets a write
        target, dropped rows the pool's scratch slot."""
        pos = offsets[:, None] + torch.arange(S, device=offsets.device)
        slots = paged_write_slots(tables, pos, valid, block_size,
                                  scratch_slot)
        return PagedStep(positions=pos, write_rows=None, write_slots=slots,
                         tables=tables, lengths=offsets.to(torch.int32))

    # -------------------------------------------------------- runner cache
    def _runner_cache(self):
        cache = getattr(self, "_generate_cache", None)
        if cache is None:
            cache = self._generate_cache = {}
        return cache

    def _runner_for(self, cache_key, make_run):
        """Build-or-fetch the runner of ``cache_key``; one build under
        concurrency (JAX ``generation.py:201-220``). The hit path takes no
        lock; only a cold build serialises. Returns (run, compiled_now)."""
        pool = getattr(self, "_graph_pool_handle", None)
        if pool is not None and poisoned(pool):
            with _TRACE_LOCK:       # a failed capture: runners move pools
                self._graph_pool()
        cache = self._runner_cache()
        run = cache.get(cache_key)
        if run is not None:
            return run, False
        with _TRACE_LOCK:
            run = cache.get(cache_key)
            if run is not None:
                return run, False
            run = cache[cache_key] = make_run()
            return run, True

    def _graph_pool(self):
        """The graph memory pool every capture of this model allocates from
        (None on the CPU). After a failed capture into it the model moves
        to a fresh pool and drops the runners that hold the old one
        (``jit.graphs.poisoned``). Called under ``_TRACE_LOCK``."""
        if self.device.type != "cuda":
            return None
        pool = getattr(self, "_graph_pool_handle", None)
        if pool is not None and poisoned(pool):
            self._drop_pool_runners(pool)
            pool = None
        if pool is None:
            pool = self._graph_pool_handle = torch.cuda.graph_pool_handle()
        return pool

    def _drop_pool_runners(self, pool):
        cache = self._runner_cache()
        for key, run in list(cache.items()):
            if getattr(run, "pool", None) == pool:
                cache.pop(key, None)

    def _watch_pool(self, kv_cache):
        """Drop the runners over ``kv_cache``'s pools when the cache dies
        (they hold its pools, not the cache). Called under
        ``_TRACE_LOCK``."""
        watched = self.__dict__.setdefault("_watched_pools", set())
        if kv_cache.uid not in watched:
            watched.add(kv_cache.uid)
            weakref.finalize(kv_cache, _drop_runners, weakref.ref(self),
                             ("pool", kv_cache.uid))

    def _keep_recent(self, cache_key, limit):
        """Mark a runner used; drop the least recently used of its kind
        (``cache_key[0]``) beyond ``limit``."""
        with _TRACE_LOCK:
            order = self.__dict__.setdefault("_recent", {}).setdefault(
                cache_key[0], [])
            if cache_key in order:
                order.remove(cache_key)
            order.append(cache_key)
            while len(order) > limit:
                self._runner_cache().pop(order.pop(0), None)

    def _runners(self, kind, *shape):
        """The cached base runners of ``kind`` whose key starts with
        ``shape``; a LoRA runner (its key ends in ``("bank", uid)``,
        ``adapter_key_part``) is not one of them."""
        n = 1 + len(shape)
        return [run for key, run in list(self._runner_cache().items())
                if key[:n] == (kind, *shape)
                and not (isinstance(key[-1], tuple)
                         and key[-1][:1] == ("bank",))]

    # ------------------------------------------------------------- hooks
    @staticmethod
    def _check_deadline(deadline, where):
        """Refuse a launch whose budget is already spent (JAX
        ``generation.py:273-281``)."""
        if deadline is not None and deadline.expired():
            from ..inference.resilience import DeadlineExceeded

            raise DeadlineExceeded(f"deadline expired before {where}")

    @staticmethod
    def _emit_timing(timing_hook, path, B, P, new_tokens, compiled, t0,
                     device, flops=None):
        """Per-call timing hook (JAX ``generation.py:222-240``): host wall
        of the call, the device synchronised first. ``compiled`` is True on
        the call that built (and on CUDA captured) the program; ``flops``
        the program's FLOPs per call, given only when the hook sets
        ``wants_flops``."""
        if timing_hook is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        timing_hook({"path": path, "batch": int(B), "prompt_len": int(P),
                     "new_tokens": int(new_tokens), "compiled": bool(compiled),
                     "launch_s": dt, "flops": flops,
                     "per_token_s": dt / max(1, int(new_tokens))})

    @staticmethod
    def _wants_flops(timing_hook) -> bool:
        return bool(getattr(timing_hook, "wants_flops", False))

    @staticmethod
    def _make_slot_sampler(eos):
        """Per-slot sampler: ``sample(lg [S, V], noise, finished, temps
        [S], top_ks [S])``. ``noise`` is [S] uniforms in [0, 1) or a
        ``torch.Generator`` to draw them from. The sort and the draw always
        run; ``temps > 0`` picks the draw over the argmax."""

        def sample(lg, noise, finished, temps, top_ks):
            lg32 = lg.float()
            if isinstance(noise, torch.Generator):
                noise = torch.rand(lg32.shape[0], generator=noise,
                                   device=noise.device).to(lg32.device)
            probs = torch.softmax(_cut_logits(lg32, temps, top_ks), dim=-1)
            nxt = torch.where(temps > 0, _inverse_cdf(probs, noise),
                              lg32.argmax(dim=-1))
            if eos >= 0:
                nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
                finished = finished | (nxt == eos)
            return nxt, finished

        return sample

    @staticmethod
    def _uniforms(seed, shape):
        """The call's uniforms in [0, 1), drawn on the host from ``seed``."""
        return torch.rand(shape, generator=make_generator(seed, "cpu"))

    # ------------------------------------------------------------ dense path
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, eos_token_id=None, seed=0, dtype="bfloat16",
                 decode_kernel="kernel", deadline=None, timing_hook=None):
        """Autoregressive decoding with dense per-layer KV caches.

        input_ids [B, P] (numpy or torch ints). temperature <= 0 is greedy;
        otherwise softmax sampling at that temperature with top-k
        truncation (top_k <= 0: none), at uniforms drawn from a
        ``torch.Generator`` seeded with ``seed``. EOS positions freeze once
        hit. Returns [B, P + max_new_tokens] ids (prompt + new) on the
        model's device, in the prompt's dtype.

        The caches are [B, Hkv, P + bucket_new_tokens(n), D] per layer, in
        ``dtype`` ('bfloat16' by default, with the f32 parameters cast
        once, cached; None keeps the parameters as they are over f32
        caches), owned by the runner of the call's key (B, P, bucket, eos,
        dtype, decode kernel), so the n - 1 decode forwards stay inside
        them. The runner holds two programs: the prefill forward
        (the prompt's rows, then the first token) and one decode forward,
        which writes one row, samples the next token at a device step
        index into a static [B, bucket] buffer and feeds it to the next run
        — so n - 1 decode runs need no host copy. The JAX scan runs the
        whole bucket and truncates; this loop stops after n forwards, which
        gives the same first n tokens (each depends only on the prefix),
        and n forwards' kernel launches: budgets of one bucket share one
        program.

        ``decode_kernel``: "kernel" (the dense split-KV kernel on CUDA,
        its plain version on CPU) or "plain". ``deadline`` raises
        DeadlineExceeded instead of starting an expired call;
        ``timing_hook`` receives the call's host timing."""
        dev = self.device
        ids = torch.as_tensor(input_ids)
        if ids.dim() != 2:
            raise ValueError(f"input_ids [B, P] expected, got "
                             f"{tuple(ids.shape)}")
        B, P = ids.shape
        self._decode_validate(P, max_new_tokens)
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bucket = bucket_new_tokens(n)
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        state, state_key = self._state_for_key(dtype)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        g = self._tp()
        cache_key = ("dense", B, P, bucket, eos, str(ids.dtype),
                     str(dtype), decode_kernel,
                     ("tp", None if g is None else g.id), state_key)
        run, compiled_now = self._runner_for(
            cache_key, lambda: self._make_dense_runner(
                B, P, bucket, eos, state, dtype, decode_kernel))
        self._keep_recent(cache_key, _DENSE_RUNNERS)
        self._check_deadline(deadline, "dense decode launch")
        u = self._uniforms(seed, (bucket, B))
        t0 = time.perf_counter()
        with run.lock:
            run.fill(ids=ids,
                     temps=np.broadcast_to(np.asarray(
                         0.0 if temperature is None else temperature,
                         np.float32), (B,)),
                     top_ks=np.broadcast_to(np.asarray(top_k or 0,
                                                       np.int64), (B,)),
                     u=u)
            run.run("prefill")
            for _ in range(n - 1):
                run.run("decode")
            out = torch.cat([run.inputs.dev["ids"],
                             run.outputs.dev["tokens"][:, :n]],
                            dim=1).to(ids.dtype)
        self._emit_timing(timing_hook, "dense", B, P, n, compiled_now, t0,
                          dev)
        return out

    def _make_dense_runner(self, B, P, bucket, eos, state, dtype,
                           decode_kernel):
        """The runner of one dense key: its caches, its device state (the
        current token, length, step index and EOS flags) and two programs.
        """
        dev = self.device
        cache_dtype = torch.float32 if dtype is None else dtype
        num_layers, _, head_dim = self._decode_cache_spec()
        shape = (B, self._local_kv_heads(), P + bucket, head_dim)
        kc = [torch.zeros(shape, dtype=cache_dtype, device=dev)
              for _ in range(num_layers)]
        vc = [torch.zeros(shape, dtype=cache_dtype, device=dev)
              for _ in range(num_layers)]
        carry = {"tok": torch.zeros(B, dtype=torch.int64, device=dev),
                 "length": torch.zeros(B, dtype=torch.int32, device=dev),
                 "at_zero": torch.zeros(B, dtype=torch.int32, device=dev),
                 "step": torch.zeros(1, dtype=torch.int64, device=dev),
                 "finished": torch.zeros(B, dtype=torch.bool, device=dev)}
        sample = self._make_slot_sampler(eos)

        def rebuild(c):
            state, kc, vc = c["state"], c["k"], c["v"]
            tok, length, step = c["tok"], c["length"], c["step"]
            at_zero, finished = c["at_zero"], c["finished"]

            def prefill(inp, out):
                lg = self._decode_call(state, inp["ids"], kc, vc,
                                       DenseStep(at_zero), decode_kernel)
                nxt, fin = sample(lg[:, -1], inp["u"][0],
                                  torch.zeros_like(finished), inp["temps"],
                                  inp["top_ks"])
                out["tokens"][:, 0] = nxt
                tok.copy_(nxt)
                finished.copy_(fin)
                length.fill_(P)
                step.fill_(1)

            def decode(inp, out):
                lg = self._decode_call(state, tok[:, None], kc, vc,
                                       DenseStep(length), decode_kernel)
                i = step.clamp(max=bucket - 1)
                nxt, fin = sample(lg[:, -1], inp["u"].index_select(0, i)[0],
                                  finished, inp["temps"], inp["top_ks"])
                out["tokens"].index_copy_(1, i, nxt[:, None])
                tok.copy_(nxt)
                finished.copy_(fin)
                length.add_(1)
                step.add_(1)

            return {"prefill": prefill, "decode": decode}

        # the tensors the programs close over; analysis.trace_runner
        # rebuilds them over fake stand-ins
        closed = {"state": state, "k": kc, "v": vc, **carry}
        run = StepRunner(
            dev,
            inputs={"ids": ((B, P), torch.int64),
                    "temps": ((B,), torch.float32),
                    "top_ks": ((B,), torch.int64),
                    "u": ((bucket, B), torch.float32)},
            outputs={"tokens": ((B, bucket), torch.int64)},
            programs=rebuild(closed),
            pool=self._graph_pool())
        run.trace_parts = (rebuild, closed)
        return run

    def compiled_generate_runner(self, batch, prompt_len, max_new_tokens):
        """The cached runner of a prior generate() shape, or None (JAX
        ``generation.py:408-418``). ``max_new_tokens`` resolves through the
        declared bucket set, as generate() keys on it."""
        found = self._runners("dense", batch, prompt_len,
                              bucket_new_tokens(max_new_tokens))
        return found[0] if found else None

    # ------------------------------------------------------------ paged path
    @torch.no_grad()
    def generate_paged(self, input_ids, prompt_lens, kv_cache, block_tables,
                       max_new_tokens=32, temperature=0.0, top_k=0,
                       eos_token_id=None, seed=0, decode_kernel="kernel",
                       deadline=None, timing_hook=None, adapters=None,
                       adapter_slots=None):
        """Whole-batch autoregressive decoding over a SHARED paged pool.

        input_ids [B, P] prompts right-padded to a common P; prompt_lens [B]
        each request's true length (padding rows write nothing and are
        masked by the per-request lengths); kv_cache a ``PagedKVCache``
        whose pools are updated in place; block_tables [B, NB] page ids
        covering each request's prompt + max_new_tokens rows.

        One program per key (B, P, n, NB, pool signature, eos, decode
        kernel, pool, decode state), JAX's ``("paged", B, P, n, ...)``
        key: the prefill forward and n - 1 decode forwards, each writing
        its input token's row at the request's next position, captured as
        ONE graph on CUDA and replayed (the ``_PAGED_RUNNERS`` most
        recently used are kept). Prompt lengths, tables, sampler knobs and
        the uniforms ride the key's static buffers. A call is one fill,
        one replay and one read.

        Returns [B, max_new_tokens] int64 new tokens (numpy): per request b
        the continuation of input_ids[b, :prompt_lens[b]], the same tokens
        as dense ``generate()`` of that prompt alone. (The JAX scan writes
        the first decode row one position late, ``generation.py:503-504``;
        the port writes it at prompt_lens[b], ROADMAP C.) ``deadline``
        raises DeadlineExceeded instead of starting an expired call;
        ``timing_hook`` receives the call's host timing (path "paged")."""
        ids = np.asarray(input_ids, np.int64)
        B, P = ids.shape
        plens = np.asarray(prompt_lens, np.int64).reshape(B)
        if (plens < 1).any() or (plens > P).any():
            raise ValueError(f"prompt_lens must lie in [1, {P}]: {plens}")
        # the longest prompt, not P: the whole-batch predictor pads P
        self._decode_validate(int(plens.max()), max_new_tokens)
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        tables = np.asarray(block_tables, np.int32)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        sample = self._make_slot_sampler(eos)

        def make_body(state, k_pages, v_pages, bs, scratch):
            def body(inp, out):
                lens, tbl = inp["plens"], inp["tables"]
                dev = lens.device
                valid = torch.arange(P, device=dev)[None, :] < lens[:, None]
                step = self._device_step(torch.zeros_like(lens), P, tbl,
                                         valid, bs, scratch)
                lg = self._decode_call(state, inp["ids"], k_pages, v_pages,
                                       step, decode_kernel)
                last = lg[torch.arange(B, device=dev), lens - 1]
                tok, finished = sample(
                    last, inp["u"][0], torch.zeros(B, dtype=torch.bool,
                                                   device=dev),
                    inp["temps"], inp["top_ks"])
                out["tokens"][:, 0] = tok
                every = torch.ones((B, 1), dtype=torch.bool, device=dev)
                for j in range(1, n):
                    # forward j writes row lens + j - 1
                    step = self._device_step(lens + (j - 1), 1, tbl, every,
                                             bs, scratch)
                    lg = self._decode_call(state, tok[:, None], k_pages,
                                           v_pages, step, decode_kernel)
                    tok, finished = sample(lg[:, -1], inp["u"][j], finished,
                                           inp["temps"], inp["top_ks"])
                    out["tokens"][:, j] = tok
            return body

        run, compiled_now = self._step_runner(
            "paged", (B, P, n), kv_cache, eos, decode_kernel,
            {"ids": ((B, P), torch.int64), "plens": ((B,), torch.int64),
             "tables": (tables.shape, torch.int32),
             "temps": ((B,), torch.float32), "top_ks": ((B,), torch.int64),
             "u": ((n, B), torch.float32)},
            {"tokens": ((B, n), torch.int64)}, make_body,
            keep=_PAGED_RUNNERS, adapters=adapters)
        self._check_deadline(deadline, "paged decode launch")
        out = self._run_step(
            run, compiled_now, timing_hook, "paged", (B, P, n),
            dict(ids=ids, plens=plens, tables=tables,
                 temps=np.broadcast_to(np.asarray(
                     0.0 if temperature is None else temperature,
                     np.float32), (B,)),
                 top_ks=np.broadcast_to(np.asarray(top_k or 0, np.int64),
                                        (B,)),
                 u=self._uniforms(seed, (n, B)),
                 **self._adapter_values(adapters, adapter_slots, B)))
        return out["tokens"]

    def compiled_generate_paged_runner(self, batch, prompt_len,
                                       max_new_tokens):
        """The cached runner of a prior generate_paged() shape, or None
        (JAX ``generation.py:420-431``)."""
        found = self._runners("paged", batch, prompt_len,
                              int(max_new_tokens))
        return found[0] if found else None

    # --------------------------------------------- continuous-batching steps
    @torch.no_grad()
    def chunk_logits(self, chunk_ids, offsets, chunk_lens, kv_cache,
                     block_tables, decode_kernel="kernel"):
        """The forward of ``prefill_chunk`` without the sampler, eagerly:
        writes the chunk's K/V into ``kv_cache`` in place and returns the
        [S, V] logits at each chunk's last valid position (on the model's
        device). A width-1 chunk at offsets = lengths is one decode step."""
        self._check_pool(kv_cache)
        dev = self.device
        ids = torch.as_tensor(np.asarray(chunk_ids, np.int64), device=dev)
        S, C = ids.shape
        lens = torch.as_tensor(np.asarray(chunk_lens, np.int64), device=dev)
        step = self._device_step(
            torch.as_tensor(np.asarray(offsets, np.int64), device=dev), C,
            torch.as_tensor(np.asarray(block_tables, np.int32), device=dev),
            torch.arange(C, device=dev)[None, :] < lens[:, None],
            kv_cache.block_size, kv_cache.scratch_slot)
        logits = self._decode_call(self._decode_state(kv_cache.dtype), ids,
                                   kv_cache.k_pages, kv_cache.v_pages, step,
                                   decode_kernel)
        return logits[torch.arange(S, device=dev), (lens - 1).clamp(min=0)]

    def _step_runner(self, kind, shape, kv_cache, eos, decode_kernel,
                     inputs, outputs, make_body, keep=None, adapters=None):
        """(run, compiled_now) of a paged step program:
        ``kind`` and ``shape`` (slots, width) lead the key as in JAX, then
        the table width, the pool signature, eos, the ids dtype, the decode
        kernel, the pool and the decode state. ``make_body(state, k_pages,
        v_pages, block_size, scratch_slot)`` -> body(inputs, outputs).
        ``keep`` bounds the runners of ``kind`` kept, least recently used
        dropped first.

        ``adapters`` (an ``inference.adapters.AdapterRegistry``): the
        program gains an ``aidx`` [slots] int32 input and runs its body
        under ``adapters.applied`` over the registry's bank tensors; the
        key grows the bank's shape (``signature()``) and, since a graph
        holds the bank's addresses as it holds the pool's, the registry's
        id. Adapter contents and mix are inputs: they never change a
        key."""
        self._check_pool(kv_cache)
        state, state_key = self._state_for_key(kv_cache.dtype)
        NB = inputs["tables"][0][1]
        cache_key = (kind, *shape, NB, kv_cache.signature(), eos, "int64",
                     decode_kernel, ("pool", kv_cache.uid), state_key)
        if adapters is not None:
            cache_key += adapter_key_part(adapters)
            inputs = {**inputs, "aidx": ((shape[0],), torch.int32)}

        def make_run():
            self._watch_pool(kv_cache)
            bs, scratch = kv_cache.block_size, kv_cache.scratch_slot

            def rebuild(c):
                body = make_body(c["state"], c["k_pages"], c["v_pages"], bs,
                                 scratch)
                if c["bank"] is not None:
                    body = _with_adapters(body, c["bank"])
                return {"step": body}

            # the tensors the body closes over (the pools, not the cache: a
            # runner must not keep the cache alive); analysis.trace_runner
            # rebuilds the body over fake stand-ins of them
            closed = {"state": state, "k_pages": kv_cache.k_pages,
                      "v_pages": kv_cache.v_pages,
                      "bank": None if adapters is None else adapters.bank()}
            run = StepRunner(self.device, inputs, outputs, rebuild(closed),
                             pool=self._graph_pool())
            run.trace_parts = (rebuild, closed)
            return run

        found = self._runner_for(cache_key, make_run)
        if keep is not None:
            self._keep_recent(cache_key, keep)
        return found

    @staticmethod
    def _adapter_values(adapters, adapter_slots, S):
        """The ``aidx`` input of a LoRA step program: the [S] bank index
        (row 0, the identity, where none is given); {} without a
        registry."""
        if adapters is None:
            return {}
        if adapter_slots is None:
            return {"aidx": np.zeros(S, np.int32)}
        return {"aidx": np.asarray(adapter_slots, np.int32).reshape(S)}

    def _run_step(self, run, compiled_now, timing_hook, path, timing,
                  values):
        """One call of a step program: fill, run, read back, timing hook.
        A hook that sets ``wants_flops`` gets the program's FLOPs per call,
        counted once per key over a run of its body and kept on the runner
        (JAX ``generation.py:242-265``: aten products; the hand-written
        attention kernel is not counted)."""
        wants = self._wants_flops(timing_hook)
        t0 = time.perf_counter()
        with run.lock:
            run.fill(**values)
            run.run("step", count_flops=wants)
            out = run.read()
        self._emit_timing(timing_hook, path, *timing, compiled_now, t0,
                          self.device,
                          flops=cost_flops(run) if wants else None)
        return out

    @torch.no_grad()
    def prefill_chunk(self, chunk_ids, offsets, chunk_lens, kv_cache,
                      block_tables, temperature=0.0, top_k=0,
                      eos_token_id=None, seed=0, decode_kernel="kernel",
                      timing_hook=None, adapters=None, adapter_slots=None):
        """One chunked-prefill step over the shared paged pool.

        chunk_ids [S, C] (right-padded), offsets [S] cache length before the
        chunk, chunk_lens [S] valid tokens (0: idle slot, writes dropped),
        block_tables [S, NB]. Writes the chunk's K/V into ``kv_cache`` in
        place and returns [S] int64 next-token samples from each chunk's
        last valid position (numpy). One program per (S, C, NB, pool,
        eos, decode kernel): the forward, the last-position gather and the
        sampler.

        ``adapters`` / ``adapter_slots`` (here and in ``decode_step``,
        ``verify_step`` and ``generate_paged``): an ``AdapterRegistry`` and
        each slot's [S] bank row (None: row 0, the base model), the LoRA
        variant of the program (``_step_runner``)."""
        ids = np.asarray(chunk_ids, np.int64)
        S, C = ids.shape
        tables = np.asarray(block_tables, np.int32)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        sample = self._make_slot_sampler(eos)

        def make_body(state, k_pages, v_pages, bs, scratch):
            def body(inp, out):
                offs, lens = inp["offsets"], inp["lens"]
                valid = (torch.arange(C, device=lens.device)[None, :]
                         < lens[:, None])
                step = self._device_step(offs, C, inp["tables"], valid, bs,
                                         scratch)
                lg = self._decode_call(state, inp["ids"], k_pages, v_pages,
                                       step, decode_kernel)
                last = lg[torch.arange(S, device=lg.device),
                          (lens - 1).clamp(min=0)]
                nxt, _ = sample(last, inp["u"],
                                torch.zeros(S, dtype=torch.bool,
                                            device=lg.device),
                                inp["temps"], inp["top_ks"])
                out["tokens"].copy_(nxt)
            return body

        run, compiled_now = self._step_runner(
            "prefill_chunk", (S, C), kv_cache, eos, decode_kernel,
            {"ids": ((S, C), torch.int64), "offsets": ((S,), torch.int64),
             "lens": ((S,), torch.int64), "tables": (tables.shape,
                                                     torch.int32),
             "temps": ((S,), torch.float32), "top_ks": ((S,), torch.int64),
             "u": ((S,), torch.float32)},
            {"tokens": ((S,), torch.int64)}, make_body, adapters=adapters)
        out = self._run_step(
            run, compiled_now, timing_hook, "prefill_chunk", (S, C, 0),
            dict(ids=ids, offsets=np.asarray(offsets, np.int64),
                 lens=np.asarray(chunk_lens, np.int64), tables=tables,
                 temps=np.broadcast_to(np.asarray(temperature, np.float32),
                                       (S,)),
                 top_ks=np.broadcast_to(np.asarray(top_k, np.int64), (S,)),
                 u=self._uniforms(seed, (S,)),
                 **self._adapter_values(adapters, adapter_slots, S)))
        return out["tokens"]

    @torch.no_grad()
    def decode_step(self, tokens, lengths, active, kv_cache, block_tables,
                    steps=1, max_lens=None, temperature=0.0, top_k=0,
                    eos_token_id=None, seed=0, decode_kernel="kernel",
                    timing_hook=None, adapters=None, adapter_slots=None):
        """``steps`` decode iterations for a fixed-width slot batch.

        tokens [S] current input per slot (not yet in the cache), lengths
        [S] rows present, active [S] slot mask, max_lens [S] per-slot write
        ceiling (writes at positions >= max_lens are dropped; None: no
        ceiling). Active slots advance one row per step; idle slots write
        nothing and hold their token. Returns [S, steps] int64 (numpy).
        One program per (S, steps, NB, pool, eos, decode kernel) runs all
        the steps, the ``lax.scan``'s counterpart: lengths advance on the
        device, validity is ``active & (lengths < max_lens)``, EOS flags
        carry from step to step."""
        tok = np.asarray(tokens, np.int64)
        S, T = tok.shape[0], int(steps)
        lens = np.asarray(lengths, np.int64)
        tables = np.asarray(block_tables, np.int32)
        lmax = (lens + T if max_lens is None
                else np.asarray(max_lens, np.int64))
        eos = -1 if eos_token_id is None else int(eos_token_id)
        sample = self._make_slot_sampler(eos)

        def make_body(state, k_pages, v_pages, bs, scratch):
            def body(inp, out):
                cur, lens, act = inp["tokens"], inp["lengths"], inp["active"]
                finished = torch.zeros(S, dtype=torch.bool, device=cur.device)
                for i in range(T):
                    valid = (act & (lens < inp["max_lens"]))[:, None]
                    step = self._device_step(lens, 1, inp["tables"], valid,
                                             bs, scratch)
                    lg = self._decode_call(state, cur[:, None], k_pages,
                                           v_pages, step, decode_kernel)
                    nxt, finished = sample(lg[:, -1], inp["u"][i], finished,
                                           inp["temps"], inp["top_ks"])
                    cur = torch.where(act, nxt, cur)    # idle slots hold
                    out["tokens"][:, i] = cur
                    lens = lens + act
            return body

        run, compiled_now = self._step_runner(
            "decode_step", (S, T), kv_cache, eos, decode_kernel,
            {"tokens": ((S,), torch.int64), "lengths": ((S,), torch.int64),
             "active": ((S,), torch.bool), "max_lens": ((S,), torch.int64),
             "tables": (tables.shape, torch.int32),
             "temps": ((S,), torch.float32), "top_ks": ((S,), torch.int64),
             "u": ((T, S), torch.float32)},
            {"tokens": ((S, T), torch.int64)}, make_body, adapters=adapters)
        out = self._run_step(
            run, compiled_now, timing_hook, "decode_step", (S, 1, T),
            dict(tokens=tok, lengths=lens,
                 active=np.asarray(active, bool), max_lens=lmax,
                 tables=tables,
                 temps=np.broadcast_to(np.asarray(temperature, np.float32),
                                       (S,)),
                 top_ks=np.broadcast_to(np.asarray(top_k, np.int64), (S,)),
                 u=self._uniforms(seed, (T, S)),
                 **self._adapter_values(adapters, adapter_slots, S)))
        return out["tokens"]

    # ------------------------------------------------------ speculative
    @torch.no_grad()
    def verify_step(self, chunk_ids, offsets, draft_lens, active, kv_cache,
                    block_tables, max_lens=None, temperature=0.0, top_k=0,
                    seed=0, decode_kernel="kernel", timing_hook=None,
                    adapters=None, adapter_slots=None):
        """Speculative draft verification over the paged pool.

        chunk_ids [S, K+1]: position 0 is each slot's current input token
        (its K/V not yet written), positions 1..K its drafted tokens (zeros
        past draft_lens). offsets [S] cache rows present; draft_lens [S]
        valid drafts (0: a plain one-token decode); active [S] slot mask
        (idle slots write nothing and hold their token); max_lens [S] write
        ceiling (rows at positions >= max_lens are dropped; None: none).

        One forward of width K+1 through the paged kernel writes the whole
        window (under the ceiling), so rejected rows are overwritten by the
        next call before any position can attend to them: rollback is the
        caller's length bookkeeping only. The logits go through the
        sampler's temperature / top-k transform per position; draft j is
        accepted iff every earlier draft was and, greedy (temperature <=
        0), it is the target's argmax, or, sampled, u_j < p(d_j) with u_j
        uniform from a ``torch.Generator`` seeded with ``seed``. The token
        after the accepted prefix comes from the target's law there, with
        the rejected draft masked out on a rejection (the residual of a
        point-mass draft). The output law is therefore the target's. One
        program per (S, K+1, NB, pool, decode kernel): the forward and the
        whole accept / residual computation.

        Returns (accepted [S] int32 in 0..K, next [S] int64), numpy."""
        ids = np.asarray(chunk_ids, np.int64)
        S, W = ids.shape
        if W < 2:
            raise ValueError("verify_step needs at least one draft position "
                             f"(chunk width {W} = current token + K drafts)")
        K = W - 1
        offs = np.asarray(offsets, np.int64).reshape(S)
        tables = np.asarray(block_tables, np.int32)
        lmax = (offs + W if max_lens is None
                else np.asarray(max_lens, np.int64).reshape(S))

        def make_body(state, k_pages, v_pages, bs, scratch):
            def body(inp, out):
                chunk, offs, act = inp["ids"], inp["offsets"], inp["active"]
                dlens, temps = inp["draft_lens"], inp["temps"]
                dev = chunk.device
                valid = act[:, None] & (
                    (offs[:, None] + torch.arange(W, device=dev)[None, :])
                    < inp["max_lens"][:, None])
                step = self._device_step(offs, W, inp["tables"], valid, bs,
                                         scratch)
                lg32 = self._decode_call(state, chunk, k_pages, v_pages,
                                         step, decode_kernel).float()
                vocab = lg32.shape[-1]
                cut = _cut_logits(lg32, temps, inp["top_ks"])
                probs = torch.softmax(cut, dim=-1)
                drafts = chunk[:, 1:]                          # [S, K]
                p_draft = probs[:, :K].gather(-1, drafts[..., None])[..., 0]
                greedy_ok = drafts == lg32[:, :K].argmax(dim=-1)
                acc = torch.where(temps[:, None] > 0,
                                  inp["u_accept"] < p_draft, greedy_ok)
                live = (torch.arange(K, device=dev)[None, :]
                        < dlens[:, None])
                acc = acc & live & act[:, None]
                accepted = acc.long().cumprod(dim=1).sum(dim=1)  # 0..K
                # the logits at the accept point saw the accepted prefix
                nxt_lg = cut.gather(
                    1, accepted[:, None, None].expand(S, 1, vocab))[:, 0]
                rejected = accepted < dlens
                rej_tok = drafts.gather(
                    1, accepted.clamp(0, K - 1)[:, None])[:, 0]
                res_mask = rejected[:, None] & (
                    torch.arange(vocab, device=dev)[None, :]
                    == rej_tok[:, None])
                nxt_lg = torch.where(res_mask,
                                     torch.full_like(nxt_lg, _F32_MIN),
                                     nxt_lg)
                draw = _inverse_cdf(torch.softmax(nxt_lg, dim=-1),
                                    inp["u_next"])
                nxt = torch.where(temps > 0, draw, nxt_lg.argmax(dim=-1))
                out["next"].copy_(torch.where(act, nxt, chunk[:, 0]))
                out["accepted"].copy_(torch.where(
                    act, accepted, torch.zeros_like(accepted)))
            return body

        run, compiled_now = self._step_runner(
            "verify_step", (S, W), kv_cache, -1, decode_kernel,
            {"ids": ((S, W), torch.int64), "offsets": ((S,), torch.int64),
             "draft_lens": ((S,), torch.int64),
             "active": ((S,), torch.bool), "max_lens": ((S,), torch.int64),
             "tables": (tables.shape, torch.int32),
             "temps": ((S,), torch.float32), "top_ks": ((S,), torch.int64),
             "u_accept": ((S, K), torch.float32),
             "u_next": ((S,), torch.float32)},
            {"accepted": ((S,), torch.int32), "next": ((S,), torch.int64)},
            make_body, adapters=adapters)
        gen = make_generator(seed, "cpu")
        u_accept = torch.rand((S, K), generator=gen)
        out = self._run_step(
            run, compiled_now, timing_hook, "verify_step", (S, W, 1),
            dict(ids=ids, offsets=offs,
                 draft_lens=np.asarray(draft_lens, np.int64).reshape(S),
                 active=np.asarray(active, bool).reshape(S), max_lens=lmax,
                 tables=tables,
                 temps=np.broadcast_to(np.asarray(temperature, np.float32),
                                       (S,)),
                 top_ks=np.broadcast_to(np.asarray(top_k, np.int64), (S,)),
                 u_accept=u_accept, u_next=torch.rand(S, generator=gen),
                 **self._adapter_values(adapters, adapter_slots, S)))
        return out["accepted"], out["next"]

    def compiled_prefill_chunk_runner(self, slots, chunk):
        """The cached prefill-chunk runner of a prior prefill_chunk() shape,
        or None (JAX ``generation.py:994-1006``)."""
        found = self._runners("prefill_chunk", slots, chunk)
        return found[0] if found else None

    def compiled_decode_step_runner(self, slots, steps):
        """The cached decode-step runner of a prior decode_step() shape, or
        None (JAX ``generation.py:1008-1017``)."""
        found = self._runners("decode_step", slots, steps)
        return found[0] if found else None

    def compiled_verify_step_runner(self, slots, width):
        """The cached verify runner of a prior verify_step() shape (width
        K+1), or None (JAX ``generation.py:1019-1031``)."""
        found = self._runners("verify_step", slots, width)
        return found[0] if found else None

    def generate_speculative(self, input_ids, max_new_tokens=32, spec_k=4,
                             drafter="ngram", temperature=0.0, top_k=0,
                             eos_token_id=None, seed=0, dtype="bfloat16",
                             decode_kernel="kernel", kv_cache=None,
                             stats=None):
        """Single-stream speculative decoding: draft up to ``spec_k`` tokens
        on the host, verify them in one ``verify_step``. Same result shape
        and law as ``generate()``; see ``inference/speculative.py``."""
        from ..inference.speculative import speculative_generate

        return speculative_generate(
            self, input_ids, max_new_tokens=max_new_tokens, spec_k=spec_k,
            drafter=drafter, temperature=temperature, top_k=top_k,
            eos_token_id=eos_token_id, seed=seed, dtype=dtype,
            decode_kernel=decode_kernel, kv_cache=kv_cache, stats=stats)
