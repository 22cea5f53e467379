"""Speculative decoding: drafters and the single-stream loop — the
counterpart of ``paddle_tpu/inference/speculative.py``.

A cheap drafter proposes K tokens on the host; the target model scores all
K in ONE forward (``GenerationMixin.verify_step``, a prefill-shaped call
over the paged kernel) that also runs the accept / reject sampler.
Accepted tokens are free; the rejection resample is corrected so the
output law is EXACTLY the target model's, and greedy speculative output is
token-identical to dense ``generate()``.

Drafters implement ``draft(history, k) -> up to k tokens`` and must be
DETERMINISTIC (a point-mass draft law): that is the condition under which
``verify_step``'s acceptance test p(d_j) and masked-residual resample are
exact.

* ``NGramDrafter`` — prompt-lookup: the tokens that followed the most
  recent earlier occurrence of the history's longest suffix n-gram. Host
  only, no launches.
* ``DraftModelDrafter`` — greedy proposals of any model with the
  ``generate()`` interface from a fixed-width suffix window.
* ``SelfSpeculativeDrafter`` — the target model drafting its own
  continuation from a short window, through dense ``generate()`` (the
  dense split-KV kernel on the card).

``speculative_generate`` is the single-stream loop behind
``model.generate_speculative(...)``; the continuous scheduler's ``spec_k``
knob drafts through the same drafters, and ``SpecStats.unit_split`` gives
a run's verify rows in the utilization ledger's convention.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..analysis.lockwitness import make_module_lock
from .kv_cache import PagedKVCache

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter",
           "SelfSpeculativeDrafter", "make_drafter", "SpecStats",
           "speculative_generate"]


class Drafter:
    """Protocol for draft-token proposers (duck-typed; subclassing is
    optional). ``history`` is the full 1-D int sequence so far; return up
    to ``k`` proposed continuation tokens (empty: no proposal, the loop
    runs a plain one-token decode through the same verify call). Proposals
    must be deterministic given ``history``."""

    def draft(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup drafter: longest-suffix n-gram match against the
    sequence's own past (max_n..min_n tried longest first, the most RECENT
    earlier match wins), proposing the tokens that followed the match."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def draft(self, history, k):
        h = np.asarray(history).reshape(-1)
        L = len(h)
        k = int(k)
        if k < 1:
            return h[:0]
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pat = h[L - n:]
            # latest occurrence strictly before the suffix itself, with at
            # least one continuation token available
            for i in range(L - n - 1, -1, -1):
                if np.array_equal(h[i:i + n], pat):
                    return h[i + n:i + n + k]
        return h[:0]


class DraftModelDrafter(Drafter):
    """Greedy proposals from any model with ``generate()``: exactly ``k``
    tokens drafted from the last ``window`` tokens of the history, in
    ``dtype`` through ``decode_kernel`` (``generate()``'s knobs).
    Histories shorter than the window propose nothing."""

    def __init__(self, draft_model, window: int = 16, dtype="bfloat16",
                 decode_kernel="kernel"):
        self.model = draft_model
        self.window = int(window)
        self.dtype = dtype
        self.decode_kernel = decode_kernel

    def draft(self, history, k):
        h = np.asarray(history).reshape(-1)
        k = int(k)
        if k < 1 or len(h) < self.window:
            return h[:0]
        ctx = np.asarray(h[-self.window:], np.int64)[None]
        out = self.model.generate(ctx, max_new_tokens=k, temperature=0.0,
                                  dtype=self.dtype,
                                  decode_kernel=self.decode_kernel)
        return out[0, self.window:].cpu().numpy()


class SelfSpeculativeDrafter(DraftModelDrafter):
    """Self-speculation: the TARGET model drafts its own continuation from
    a short suffix window, cheap because it attends ``window`` tokens, not
    the full prefix."""


def make_drafter(spec, model=None, dtype="bfloat16",
                 decode_kernel="kernel") -> Drafter:
    """Resolve a drafter knob: 'ngram' | 'self' | a Drafter instance. The
    self-drafter drafts in ``dtype`` through ``decode_kernel``, the
    speculative loop's own."""
    if spec is None:
        return NGramDrafter()
    if isinstance(spec, str):
        if spec == "ngram":
            return NGramDrafter()
        if spec == "self":
            if model is None:
                raise ValueError("drafter='self' needs the target model")
            return SelfSpeculativeDrafter(model, dtype=dtype,
                                          decode_kernel=decode_kernel)
        raise ValueError(f"unknown drafter {spec!r} "
                         "(expected 'ngram', 'self', or a Drafter)")
    if hasattr(spec, "draft"):
        return spec
    raise ValueError(f"not a drafter: {spec!r} (needs .draft(history, k))")


class SpecStats:
    """Per-run speculation accounting: wasted = drafted - accepted is the
    draft work (and verify width) spent on rejected tokens; the acceptance
    rate decides whether speculation pays."""

    __slots__ = ("drafted", "accepted", "launches", "emitted")

    def __init__(self):
        self.drafted = 0        # draft tokens submitted to verify
        self.accepted = 0       # draft tokens accepted by the target
        self.launches = 0       # verify calls (each also emits 1 token)
        self.emitted = 0        # total tokens produced

    @property
    def wasted(self) -> int:
        return self.drafted - self.accepted

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def to_dict(self) -> dict:
        return {"drafted": self.drafted, "accepted": self.accepted,
                "wasted": self.wasted, "launches": self.launches,
                "emitted": self.emitted,
                "acceptance_rate": round(self.acceptance_rate, 4)}

    def unit_split(self, width) -> tuple[int, int, int]:
        """(useful, spec_waste, pad) verify-row units for the utilization
        ledger, out of ``launches * width`` rows: every emitted token was a
        useful row, every rejected draft a spec-waste row, the rest of each
        fixed-width launch padding (the scheduler's per-tick convention)."""
        total = self.launches * int(width)
        useful = min(self.emitted, total)
        spec = min(self.wasted, total - useful)
        return useful, spec, total - useful - spec

    def __repr__(self):
        return f"SpecStats({self.to_dict()})"


_RID = itertools.count(1)   # process-unique reservation ids (atomic draw)
_SPARE_LOCK = make_module_lock("speculative._SPARE_LOCK")
_BLOCK = 32                 # block size of the private pools


def _lend_pool(model, total, dtype):
    """A private pool for one request of ``total`` tokens: the model's
    spare one when it has that size and dtype, else a new one. The step
    programs are captured over a pool's addresses, so handing the same
    pool to the next call of that size replays them instead of capturing
    anew (JAX keys its programs on the pool's signature alone)."""
    num_blocks = (total + _BLOCK - 1) // _BLOCK + 1
    dtype = torch.float32 if dtype is None else (
        getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    with _SPARE_LOCK:
        kv = model.__dict__.pop("_spec_spare_pool", None)
    if kv is not None and (kv.num_blocks, kv.dtype) == (num_blocks, dtype):
        return kv
    return PagedKVCache(*model._decode_cache_spec(), block_size=_BLOCK,
                        num_blocks=num_blocks, dtype=dtype,
                        device=model.device, tp_group=model._tp() or False)


def _return_pool(model, kv_cache):
    """Keep ``kv_cache`` as the model's spare private pool (one at most: a
    pool of another size that was kept goes, and its programs with it)."""
    with _SPARE_LOCK:
        model.__dict__["_spec_spare_pool"] = kv_cache


def speculative_generate(model, input_ids, max_new_tokens=32, spec_k=4,
                         drafter="ngram", temperature=0.0, top_k=0,
                         eos_token_id=None, seed=0, dtype="bfloat16",
                         decode_kernel="kernel", kv_cache=None, stats=None):
    """Single-stream draft / verify decode loop.

    Semantics match ``generate()``: returns prompt + max_new_tokens ids
    (numpy, the input's leading shape: 1-D, or [1, n]), EOS freezes the
    remainder, greedy output equals dense ``generate()``'s. One
    ``prefill_chunk`` call prefills the prompt, then each iteration drafts
    up to ``spec_k`` tokens on the host and scores them in one
    ``verify_step`` (1 + accepted tokens per call).

    ``kv_cache``: an optional shared PagedKVCache; by default a private pool
    sized for this request, on the model's device, in ``dtype`` (None:
    float32), lent from the model (``_lend_pool``). ``stats``: an optional
    SpecStats accumulated in place."""
    ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                     else input_ids)
    batched = ids.ndim == 2
    if batched and ids.shape[0] != 1:
        raise ValueError("speculative_generate is the single-stream path "
                         f"(got batch {ids.shape[0]})")
    flat = ids.reshape(-1).astype(np.int64)
    plen = len(flat)
    max_new = int(max_new_tokens)
    K = int(spec_k)
    if K < 1:
        raise ValueError("spec_k must be >= 1")
    model._decode_validate(plen, max_new)
    d = make_drafter(drafter, model, dtype=dtype,
                     decode_kernel=decode_kernel)
    st = stats if stats is not None else SpecStats()
    eos = None if eos_token_id is None else int(eos_token_id)
    seed_iter = itertools.count(int(seed))

    total = plen + max_new
    private = kv_cache is None
    if private:
        kv_cache = _lend_pool(model, total, dtype)
    rid = ("spec", next(_RID))
    kv_cache.reserve(rid, total)
    table = kv_cache.block_table(rid, pad_to=kv_cache.blocks_for(total))[None]

    generated: list[int] = []

    def absorb(toks):
        for t in toks:
            if len(generated) >= max_new:
                break
            t = int(t)
            generated.append(t)
            if eos is not None and t == eos:
                generated.extend([eos] * (max_new - len(generated)))
                break
        return len(generated) >= max_new

    try:
        tok = model.prefill_chunk(
            flat[None], np.zeros(1, np.int64), np.asarray([plen], np.int64),
            kv_cache, table, temperature=temperature, top_k=top_k,
            eos_token_id=eos_token_id, seed=next(seed_iter),
            decode_kernel=decode_kernel)
        cur = int(tok[0])
        kv_cache.append_tokens(rid, plen)
        length = plen
        done = absorb([cur])

        chunk = np.zeros((1, K + 1), np.int64)
        while not done:
            history = np.concatenate([flat, np.asarray(generated, np.int64)])
            remaining = max_new - len(generated)
            proposal = np.asarray(d.draft(history, K),
                                  np.int64).reshape(-1)[:K]
            dlen = min(len(proposal), remaining - 1)
            chunk[:] = 0
            chunk[0, 0] = cur
            if dlen > 0:
                chunk[0, 1:1 + dlen] = proposal[:dlen]
            acc, nxt = model.verify_step(
                chunk, np.asarray([length], np.int64),
                np.asarray([dlen], np.int64), np.asarray([True]), kv_cache,
                table, max_lens=np.asarray([total], np.int64),
                temperature=temperature, top_k=top_k, seed=next(seed_iter),
                decode_kernel=decode_kernel)
            a, cur = int(acc[0]), int(nxt[0])
            st.drafted += dlen
            st.accepted += a
            st.launches += 1
            # rollback by bookkeeping: only the accepted prefix and the
            # emitted token become committed rows; the rest is overwritten
            # by the next call's full-width write window
            length += 1 + a
            kv_cache.append_tokens(rid, 1 + a)
            done = absorb([int(t) for t in chunk[0, 1:1 + a]] + [cur])
        st.emitted += len(generated)
    finally:
        kv_cache.mark_done(rid)
        kv_cache.release(rid)
        if private:
            _return_pool(model, kv_cache)

    out = np.concatenate([flat, np.asarray(generated, np.int64)])
    out = out.astype(ids.dtype)
    return out[None] if batched else out
