"""Autoregressive decoding — the counterpart of
``paddle_tpu/models/generation.py``: dense ``generate()`` (:284-406, with
``bucket_new_tokens`` :77), whole-batch ``generate_paged()`` (:433-537), the
continuous-batching step programs ``prefill_chunk`` (:565) and
``decode_step`` (:682), speculative ``verify_step`` (:797-974) and
``generate_speculative`` (:976), all with ``_make_slot_sampler``'s law
(:162-193).

The JAX package compiles one program per cache key and runs its decode
loops as ``lax.scan``s; here every forward is eager PyTorch launches and
the scans are Python loops. The pools of a ``PagedKVCache`` and the dense
caches of ``generate()`` are updated IN PLACE (no donation, no commit of
returned pools).

Host-known bookkeeping stays on the host: write positions, the padding /
write-ceiling masks and the per-step lengths are numpy, so building the
pool write index (the explicit stand-in for XLA's out-of-bounds-scatter
drop) never waits on the device. Tokens stay on the device across the
steps of a tick and reach the host once per call.

Sampling per slot: temperature <= 0 is greedy argmax; otherwise softmax
sampling at that temperature with top-k truncation (top_k <= 0: none),
drawn from an explicit ``torch.Generator`` seeded per call.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..framework import make_generator
from ..ops.paged_attention import paged_write_index, write_positions

__all__ = ["GenerationMixin", "bucket_new_tokens"]

_F32_MIN = torch.finfo(torch.float32).min


def bucket_new_tokens(max_new_tokens):
    """The dense path's declared ``max_new_tokens`` bucket: the next power
    of two (JAX ``generation.py:77-91``). ``generate()`` sizes its caches at
    prompt + bucket, as the JAX program does."""
    n = int(max_new_tokens)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class GenerationMixin:
    """Hooks a model provides: ``_decode_layer()`` (the module taking
    ``(ids, k_caches, v_caches, step, decode_kernel)`` and returning
    logits, where the caches are paged pools under a ``PagedStep`` and
    dense caches under a ``DenseStep``), ``_decode_cache_spec()`` ->
    (layers, kv heads, head dim) and ``device``."""

    # ------------------------------------------------------------ state cast
    def _decode_state(self, dtype):
        """The decode layer's parameters cast to ``dtype`` (f32 tensors
        only), cached until a parameter changes; None when no cast is
        needed (the parameters run as they are)."""
        layer = self._decode_layer()
        params = dict(layer.named_parameters())
        if all(p.dtype == dtype or p.dtype != torch.float32
               for p in params.values()):
            return None
        key = (dtype, tuple((id(p), p._version) for p in params.values()))
        cached = getattr(self, "_decode_state_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        with torch.no_grad():
            cast = {n: (p.to(dtype) if p.dtype == torch.float32 else p)
                    for n, p in params.items()}
        self._decode_state_cache = (key, cast)
        return cast

    def _paged_step(self, offsets, S, tables, valid, block_size):
        """Per-forward context: positions, write index and attention inputs
        from host arrays, moved to the model's device once for all layers."""
        from .gpt import PagedStep

        dev = self.device
        offs = torch.as_tensor(np.asarray(offsets, np.int64))
        tbl = torch.as_tensor(np.asarray(tables, np.int32))
        capacity = tbl.shape[1] * block_size
        pos = write_positions(offs, S)
        wpos = write_positions(offs, S, valid=torch.as_tensor(valid),
                               capacity=capacity)
        rows, slots = paged_write_index(tbl, wpos, block_size)
        return PagedStep(positions=pos.to(dev), write_rows=rows.to(dev),
                         write_slots=slots.to(dev), tables=tbl.to(dev),
                         lengths=offs.to(torch.int32).to(dev))

    def _decode_call(self, state, ids, k_caches, v_caches, step,
                     decode_kernel):
        """One model forward over the paged pools or dense caches ->
        logits [B, S, V]."""
        layer = self._decode_layer()
        args = (ids, k_caches, v_caches, step, decode_kernel)
        if state is None:
            return layer(*args)
        return torch.func.functional_call(layer, state, args)

    @staticmethod
    def _check_deadline(deadline, where):
        """Refuse a launch whose budget is already spent (JAX
        ``generation.py:273-281``)."""
        if deadline is not None and deadline.expired():
            from ..inference.resilience import DeadlineExceeded

            raise DeadlineExceeded(f"deadline expired before {where}")

    @staticmethod
    def _emit_timing(timing_hook, path, B, P, new_tokens, t0, device):
        """Per-call timing hook (JAX ``generation.py:222-240``): host wall
        of the call, the device synchronised first (only when a hook asks,
        since eager launches return before the device finishes)."""
        if timing_hook is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        timing_hook({"path": path, "batch": int(B), "prompt_len": int(P),
                     "new_tokens": int(new_tokens), "launch_s": dt,
                     "per_token_s": dt / max(1, int(new_tokens))})

    @staticmethod
    def _make_slot_sampler(eos):
        """Per-slot sampler: ``sample(lg [S, V], gen, finished, temps [S],
        top_ks [S], sampled)``; ``sampled`` is the host's knowledge that
        some slot has temperature > 0 (all-greedy ticks skip the sort)."""

        def sample(lg, gen, finished, temps, top_ks, sampled=True):
            lg32 = lg.float()
            nxt = lg32.argmax(dim=-1)
            if sampled:
                safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
                scaled = lg32 / safe_t[:, None]
                vocab = scaled.shape[-1]
                sorted_desc = scaled.sort(dim=-1, descending=True).values
                k_idx = (top_ks.clamp(1, vocab) - 1).long()
                kth = sorted_desc.gather(-1, k_idx[:, None])
                cut = torch.where((top_ks > 0)[:, None] & (scaled < kth),
                                  torch.full_like(scaled, _F32_MIN), scaled)
                draw = torch.multinomial(torch.softmax(cut, dim=-1), 1,
                                         generator=gen)[:, 0]
                nxt = torch.where(temps > 0, draw, nxt)
            if eos >= 0:
                nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
                finished = finished | (nxt == eos)
            return nxt, finished

        return sample

    def _sampler_inputs(self, temperature, top_k, S):
        temps = np.broadcast_to(np.asarray(temperature, np.float32), (S,))
        tks = np.broadcast_to(np.asarray(top_k, np.int64), (S,))
        dev = self.device
        return (torch.as_tensor(temps.copy(), device=dev),
                torch.as_tensor(tks.copy(), device=dev),
                bool((temps > 0).any()))

    # ------------------------------------------------------------ dense path
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, eos_token_id=None, seed=0, dtype="bfloat16",
                 decode_kernel="kernel", deadline=None, timing_hook=None):
        """Autoregressive decoding with dense per-layer KV caches.

        input_ids [B, P] (numpy or torch ints). temperature <= 0 is greedy;
        otherwise softmax sampling at that temperature with top-k
        truncation (top_k <= 0: none), drawn from a ``torch.Generator``
        seeded with ``seed``. EOS positions freeze once hit. Returns
        [B, P + max_new_tokens] ids (prompt + new) on the model's device, in
        the prompt's dtype.

        The caches are [B, Hkv, P + bucket_new_tokens(n), D] per layer, in
        ``dtype`` ('bfloat16' by default, with the f32 parameters cast
        once, cached; None keeps the parameters as they are over f32
        caches). One prefill forward writes the prompt's rows, then each
        decode forward writes one row and samples the next token. The JAX
        scan runs the whole bucket and truncates; this eager loop stops
        after n forwards, which gives the same first n tokens (each depends
        only on the prefix) and n forwards' kernel launches.

        ``decode_kernel``: "kernel" (the dense split-KV kernel on CUDA,
        its plain version on CPU) or "plain". ``deadline`` raises
        DeadlineExceeded instead of starting an expired call;
        ``timing_hook`` receives the call's host timing."""
        from .gpt import DenseStep

        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev)
        if ids.dim() != 2:
            raise ValueError(f"input_ids [B, P] expected, got "
                             f"{tuple(ids.shape)}")
        B, P = ids.shape
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        T = P + bucket_new_tokens(n)
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        state = None if dtype is None else self._decode_state(dtype)
        cache_dtype = torch.float32 if dtype is None else dtype
        num_layers, kv_heads, head_dim = self._decode_cache_spec()
        shape = (B, kv_heads, T, head_dim)
        k_caches = [torch.zeros(shape, dtype=cache_dtype, device=dev)
                    for _ in range(num_layers)]
        v_caches = [torch.zeros(shape, dtype=cache_dtype, device=dev)
                    for _ in range(num_layers)]
        sample = self._make_slot_sampler(-1 if eos_token_id is None
                                         else int(eos_token_id))
        temps, tks, sampled = self._sampler_inputs(
            0.0 if temperature is None else temperature, top_k or 0, B)
        gen = make_generator(seed, dev)
        self._check_deadline(deadline, "dense decode launch")
        t0 = time.perf_counter()
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        lg = self._decode_call(state, ids.long(), k_caches, v_caches,
                               DenseStep(0), decode_kernel)
        tok, finished = sample(lg[:, -1], gen, finished, temps, tks, sampled)
        toks = [tok]
        for t in range(n - 1):
            lg = self._decode_call(state, tok[:, None], k_caches, v_caches,
                                   DenseStep(P + t), decode_kernel)
            tok, finished = sample(lg[:, -1], gen, finished, temps, tks,
                                   sampled)
            toks.append(tok)
        out = torch.cat([ids, torch.stack(toks, dim=1).to(ids.dtype)], dim=1)
        self._emit_timing(timing_hook, "dense", B, P, n, t0, dev)
        return out

    # ------------------------------------------------------------ paged path
    @torch.no_grad()
    def generate_paged(self, input_ids, prompt_lens, kv_cache, block_tables,
                       max_new_tokens=32, temperature=0.0, top_k=0,
                       eos_token_id=None, seed=0, decode_kernel="kernel",
                       deadline=None):
        """Whole-batch autoregressive decoding over a SHARED paged pool.

        input_ids [B, P] prompts right-padded to a common P; prompt_lens [B]
        each request's true length (padding rows write nothing and are
        masked by the per-request lengths); kv_cache a ``PagedKVCache``
        whose pools are updated in place; block_tables [B, NB] page ids
        covering each request's prompt + max_new_tokens rows. One prefill
        forward, then max_new_tokens - 1 decode forwards, each writing its
        input token's row at the request's next position.

        Returns [B, max_new_tokens] int64 new tokens (numpy): per request b
        the continuation of input_ids[b, :prompt_lens[b]], the same tokens
        as dense ``generate()`` of that prompt alone. (The JAX scan writes
        the first decode row one position late, ``generation.py:503-504``;
        the port writes it at prompt_lens[b], ROADMAP C.)"""
        ids = np.asarray(input_ids, np.int64)
        B, P = ids.shape
        plens = np.asarray(prompt_lens, np.int64).reshape(B)
        if (plens < 1).any() or (plens > P).any():
            raise ValueError(f"prompt_lens must lie in [1, {P}]: {plens}")
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        tables = np.asarray(block_tables, np.int32)
        bs = kv_cache.block_size
        state = self._decode_state(kv_cache.dtype)
        sample = self._make_slot_sampler(-1 if eos_token_id is None
                                         else int(eos_token_id))
        temps, tks, sampled = self._sampler_inputs(
            0.0 if temperature is None else temperature, top_k or 0, B)
        dev = self.device
        gen = make_generator(seed, dev)
        self._check_deadline(deadline, "paged decode launch")
        valid = np.arange(P)[None, :] < plens[:, None]
        step = self._paged_step(np.zeros(B, np.int64), P, tables, valid, bs)
        lg = self._decode_call(state, torch.as_tensor(ids, device=dev),
                               kv_cache.k_pages, kv_cache.v_pages, step,
                               decode_kernel)
        last = lg[torch.arange(B, device=dev),
                  torch.as_tensor(plens - 1, device=dev)]
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        tok, finished = sample(last, gen, finished, temps, tks, sampled)
        toks = [tok]
        lengths = plens.copy()
        every = np.ones((B, 1), bool)
        for _ in range(n - 1):
            step = self._paged_step(lengths, 1, tables, every, bs)
            lg = self._decode_call(state, tok[:, None], kv_cache.k_pages,
                                   kv_cache.v_pages, step, decode_kernel)
            tok, finished = sample(lg[:, -1], gen, finished, temps, tks,
                                   sampled)
            toks.append(tok)
            lengths = lengths + 1
        return torch.stack(toks, dim=1).cpu().numpy()

    # --------------------------------------------- continuous-batching steps
    @torch.no_grad()
    def chunk_logits(self, chunk_ids, offsets, chunk_lens, kv_cache,
                     block_tables, decode_kernel="kernel"):
        """The forward of ``prefill_chunk`` without the sampler: writes the
        chunk's K/V into ``kv_cache`` in place and returns the [S, V]
        logits at each chunk's last valid position (on the model's
        device). A width-1 chunk at offsets = lengths is one decode step."""
        ids = np.asarray(chunk_ids, np.int64)
        S, C = ids.shape
        lens = np.asarray(chunk_lens, np.int64)
        valid = np.arange(C)[None, :] < lens[:, None]
        step = self._paged_step(offsets, C, block_tables, valid,
                                kv_cache.block_size)
        dev = self.device
        logits = self._decode_call(self._decode_state(kv_cache.dtype),
                                   torch.as_tensor(ids, device=dev),
                                   kv_cache.k_pages, kv_cache.v_pages, step,
                                   decode_kernel)
        last = torch.as_tensor(np.maximum(lens - 1, 0), device=dev)
        return logits[torch.arange(S, device=dev), last]

    @torch.no_grad()
    def prefill_chunk(self, chunk_ids, offsets, chunk_lens, kv_cache,
                      block_tables, temperature=0.0, top_k=0,
                      eos_token_id=None, seed=0, decode_kernel="kernel"):
        """One chunked-prefill step over the shared paged pool.

        chunk_ids [S, C] (right-padded), offsets [S] cache length before the
        chunk, chunk_lens [S] valid tokens (0: idle slot, writes dropped),
        block_tables [S, NB]. Writes the chunk's K/V into ``kv_cache`` in
        place and returns [S] int64 next-token samples from each chunk's
        last valid position (numpy)."""
        S = np.asarray(chunk_ids).shape[0]
        lg = self.chunk_logits(chunk_ids, offsets, chunk_lens, kv_cache,
                               block_tables, decode_kernel)
        sample = self._make_slot_sampler(-1 if eos_token_id is None
                                         else int(eos_token_id))
        temps, tks, sampled = self._sampler_inputs(temperature, top_k, S)
        dev = self.device
        tok, _ = sample(lg, make_generator(seed, dev),
                        torch.zeros(S, dtype=torch.bool, device=dev),
                        temps, tks, sampled)
        return tok.cpu().numpy()

    @torch.no_grad()
    def decode_step(self, tokens, lengths, active, kv_cache, block_tables,
                    steps=1, max_lens=None, temperature=0.0, top_k=0,
                    eos_token_id=None, seed=0, decode_kernel="kernel"):
        """``steps`` decode iterations for a fixed-width slot batch.

        tokens [S] current input per slot (not yet in the cache), lengths
        [S] rows present, active [S] slot mask, max_lens [S] per-slot write
        ceiling (writes at positions >= max_lens are dropped; None: no
        ceiling). Active slots advance one row per step; idle slots write
        nothing and hold their token. Returns [S, steps] int64 (numpy)."""
        tok = np.asarray(tokens, np.int64)
        S = tok.shape[0]
        lens = np.asarray(lengths, np.int64).copy()
        act = np.asarray(active, bool)
        lmax = (lens + int(steps) if max_lens is None
                else np.asarray(max_lens, np.int64))
        state = self._decode_state(kv_cache.dtype)
        sample = self._make_slot_sampler(-1 if eos_token_id is None
                                         else int(eos_token_id))
        temps, tks, sampled = self._sampler_inputs(temperature, top_k, S)
        dev = self.device
        gen = make_generator(seed, dev)
        cur = torch.as_tensor(tok, device=dev)
        act_dev = torch.as_tensor(act, device=dev)
        finished = torch.zeros(S, dtype=torch.bool, device=dev)
        out = []
        for _ in range(int(steps)):
            valid = (act & (lens < lmax))[:, None]
            step = self._paged_step(lens, 1, block_tables, valid,
                                    kv_cache.block_size)
            lg = self._decode_call(state, cur[:, None], kv_cache.k_pages,
                                   kv_cache.v_pages, step, decode_kernel)
            nxt, finished = sample(lg[:, -1], gen, finished, temps, tks,
                                   sampled)
            cur = torch.where(act_dev, nxt, cur)    # idle slots hold
            out.append(cur)
            lens = lens + act
        return torch.stack(out, dim=1).cpu().numpy()

    # ------------------------------------------------------ speculative
    @torch.no_grad()
    def verify_step(self, chunk_ids, offsets, draft_lens, active, kv_cache,
                    block_tables, max_lens=None, temperature=0.0, top_k=0,
                    seed=0, decode_kernel="kernel"):
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
        point-mass draft). The output law is therefore the target's.

        Returns (accepted [S] int32 in 0..K, next [S] int64), numpy."""
        ids = np.asarray(chunk_ids, np.int64)
        S, W = ids.shape
        if W < 2:
            raise ValueError("verify_step needs at least one draft position "
                             f"(chunk width {W} = current token + K drafts)")
        K = W - 1
        offs = np.asarray(offsets, np.int64).reshape(S)
        dlens = np.asarray(draft_lens, np.int64).reshape(S)
        act = np.asarray(active, bool).reshape(S)
        lmax = (offs + W if max_lens is None
                else np.asarray(max_lens, np.int64).reshape(S))
        valid = act[:, None] & ((offs[:, None] + np.arange(W)[None, :])
                                < lmax[:, None])
        step = self._paged_step(offs, W, block_tables, valid,
                                kv_cache.block_size)
        dev = self.device
        chunk = torch.as_tensor(ids, device=dev)
        lg32 = self._decode_call(self._decode_state(kv_cache.dtype), chunk,
                                 kv_cache.k_pages, kv_cache.v_pages, step,
                                 decode_kernel).float()        # [S, W, V]
        temps, tks, sampled = self._sampler_inputs(temperature, top_k, S)
        vocab = lg32.shape[-1]
        safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
        scaled = lg32 / safe_t[:, None, None]
        kth = scaled.sort(dim=-1, descending=True).values.gather(
            -1, (tks.clamp(1, vocab) - 1)[:, None, None].expand(S, W, 1))
        cut = torch.where((tks > 0)[:, None, None] & (scaled < kth),
                          torch.full_like(scaled, _F32_MIN), scaled)
        probs = torch.softmax(cut, dim=-1)
        drafts = chunk[:, 1:]                                  # [S, K]
        p_draft = probs[:, :K].gather(-1, drafts[..., None])[..., 0]
        greedy_ok = drafts == lg32[:, :K].argmax(dim=-1)
        gen = make_generator(seed, dev)
        u = torch.rand((S, K), generator=gen, device=dev)
        acc = torch.where(temps[:, None] > 0, u < p_draft, greedy_ok)
        live = (torch.arange(K, device=dev)[None, :]
                < torch.as_tensor(dlens, device=dev)[:, None])
        act_dev = torch.as_tensor(act, device=dev)
        acc = acc & live & act_dev[:, None]
        accepted = acc.long().cumprod(dim=1).sum(dim=1)        # [S] in 0..K
        # the logits at the accept point saw the accepted prefix as input
        nxt_lg = cut.gather(1, accepted[:, None, None].expand(S, 1, vocab))[
            :, 0]
        rejected = accepted < torch.as_tensor(dlens, device=dev)
        rej_tok = drafts.gather(1, accepted.clamp(0, K - 1)[:, None])[:, 0]
        res_mask = rejected[:, None] & (
            torch.arange(vocab, device=dev)[None, :] == rej_tok[:, None])
        nxt_lg = torch.where(res_mask, torch.full_like(nxt_lg, _F32_MIN),
                             nxt_lg)
        nxt = nxt_lg.argmax(dim=-1)
        if sampled:
            draw = torch.multinomial(torch.softmax(nxt_lg, dim=-1), 1,
                                     generator=gen)[:, 0]
            nxt = torch.where(temps > 0, draw, nxt)
        nxt = torch.where(act_dev, nxt, chunk[:, 0])           # idle: hold
        accepted = torch.where(act_dev, accepted, torch.zeros_like(accepted))
        return (accepted.to(torch.int32).cpu().numpy(),
                nxt.cpu().numpy())

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
