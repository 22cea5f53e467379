#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each printing its results; any failure raises and the script exits
non-zero without the final line:

1. device — CUDA must be present; prints the card's name and power limit.
2. build — every kernel source under paddle_tpu_torch/csrc/ is compiled by
   nvcc (one process per source, all started together).
3. kernel vs plain — each kernel's wrapper against its plain PyTorch
   version on the card, at the main path's shapes (decode S=1 and prefill
   S=64 over a 1024-token paged cache, GQA, padded tables, an empty slot)
   plus the other supported block sizes / head dims / group sizes, in f32
   (tolerance 1e-4: another summation order) and bf16 (elementwise
   2^-7 (|ref| + sum_j p_j |v_j|): probabilities and outputs rounded to
   bf16 at different places; ``paged_attention.kernel_tolerance``).
4. timing — kernel, plain and library (SDPA on the gathered cache, a
   yardstick only) at the decode and prefill shapes, CUDA events, median of
   25, L2 flushed between launches; the bound from this run's live bytes
   and operations.
5. flash kernels vs plain — the forward, dq and dk/dv kernels against
   their plain versions on the same inputs, each output within
   ``flash_attention.kernel_tolerance``, in f32 and bf16: the training shape
   (B=8, S=1024, H=16, D=64, causal), non-causal, D=128, GQA (Hkv=4,
   repeated as the wrapper repeats it), a ragged S=1000, and S=8192 (B=1,
   H=4), the sequence length the TPU served with its chunked backward.
6. flash timing — kernel, plain and library (scaled_dot_product_attention
   forward, and its backward, a yardstick only) at the training shape and
   at S=8192 (B=1, H=4), CUDA events, median of 25, L2 flushed; the bounds
   from this run's shapes.
7. serving — GPT-350M at full width (24 layers, random seeded weights) in
   bf16 behind ContinuousGenerateBatchingPredictor (8 slots, chunk 64,
   4 decode steps) and InferenceServer: 12 threaded requests of 50-700
   prompt tokens and 16-64 new tokens, greedy and sampled, then 2 over
   HTTP. Checks lengths, ids, pool conservation and that the kernel ran
   exactly num_layers times per model forward. In situ, two prefill chunks
   of the full model hold every layer's kernel call against the plain
   version on the same inputs, and the logits against the plain attention
   path; a planted fault (lengths one short) must fail the per-layer check.
8. training — GPT-350M at full width, O2 bf16 (``amp.decorate``), AdamW
   (lr 1e-4, weight decay 0.01, multi_precision) under TrainStep, B=8,
   S=1024, seeded ids and labels rolled by one. In situ first: one forward
   and backward holds every layer's flash forward and dq / dk / dv to the
   plain versions on the same saved inputs; two planted faults (K rolled by
   one position into the forward, lse + 0.5 into the backward kernels) must
   each fail that check; the first loss through the kernels and through the
   plain attention agree within 1%. Then the main path: 2 warm-up and 8
   timed steps on the same batch, every loss finite, the last below the
   first, exactly 3 flash launches per layer per step; step time, tokens/s,
   the share of the bf16 peak, peak memory, and a torch.profiler step.

Last lines: the kernels JSON, then {"ok": true, "device": {...}}. With
``--json PATH`` the full record (every check, timing, profile and serving
number) is also written to PATH.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |dlogit| / max |logit|, kernel path vs plain path: a coarse bound.
# With random weights the residual stream hides attention errors (a planted
# off-by-one mask moved the logits by 1.7% against 1.05% sound on an NVIDIA
# H100 80GB HBM3 at 700 W), so the per-layer check is the one a fault must
# fail.
INSITU_REL_TOL = 2.5e-2
# first training loss, flash kernels vs plain attention: a coarse bound
LOSS_REL_TOL = 1e-2


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase 3/4
def make_case(torch, B, S, Hkv, G, D, BS, lengths, dtype, device, seed,
              capacity=1024):
    """Random q and pools, per-request page tables (entries past a
    request's extent point at page 0) and lengths."""
    g = torch.Generator(device=device).manual_seed(seed)
    NB = -(-capacity // BS)
    P = B * NB
    td = getattr(torch, dtype)
    q = torch.randn((B, S, Hkv * G, D), generator=g, device=device).to(td)
    kp = torch.randn((Hkv, P, BS, D), generator=g, device=device).to(td)
    vp = torch.randn((Hkv, P, BS, D), generator=g, device=device).to(td)
    perm = torch.randperm(P, generator=g, device=device).cpu().numpy()
    tables = np.zeros((B, NB), np.int32)
    for b, ln in enumerate(lengths):
        n = -(-(ln + S) // BS)
        tables[b, :n] = perm[b * NB:b * NB + n]
    return (q, kp, vp, torch.as_tensor(tables, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


def decode_lengths(rng, B=8):
    ln = rng.integers(1, 1001, B)
    ln[3] = 0                                   # one empty slot
    return ln


def prefill_offsets(rng, B=8, S=64):
    off = rng.integers(1, 1024 - S, B)
    off[off % 32 == 0] += 1                     # never on a block boundary
    off[5] = 0
    return off


def held_to_plain(torch, pa, args, got, ref, scale=None):
    """(max |got - ref|, max of |got - ref| / the elementwise limit of
    ``kernel_tolerance``); the second is at most 1 where they agree."""
    err = (got.float() - ref.float()).abs()
    lim = pa.kernel_tolerance(*args, ref, scale=scale)
    return float(err.max()), float((err / lim).max())


def check_kernels(torch, pa, device):
    rng = np.random.default_rng(0)
    cases = []
    for dtype in ("bfloat16", "float32"):
        for G in (1, 4):
            cases.append(("decode", 8, 1, 16 // G, G, 64, 32,
                          decode_lengths(rng), dtype))
            cases.append(("prefill", 8, 64, 16 // G, G, 64, 32,
                          prefill_offsets(rng), dtype))
        cases.append(("bs16-g8", 4, 3, 2, 8, 64, 16,
                      [0, 17, 500, 1000], dtype))
        cases.append(("bs64-d128", 4, 5, 4, 4, 128, 64,
                      [3, 64, 700, 250], dtype))
        cases.append(("bs128-s128", 2, 128, 2, 1, 64, 128, [0, 777], dtype))
    results = []
    worst = {}
    for n, (name, B, S, Hkv, G, D, BS, lengths, dtype) in enumerate(cases):
        args = make_case(torch, B, S, Hkv, G, D, BS, list(lengths), dtype,
                         device, seed=100 + n)
        got = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        ref = pa.paged_decode_attention_ref(*args)
        err, over = held_to_plain(torch, pa, args, got, ref)
        ok = bool(torch.isfinite(got).all()) and over <= 1.0
        rec = dict(case=name, dtype=dtype, B=B, S=S, Hq=Hkv * G, Hkv=Hkv,
                   D=D, BS=BS, max_abs_err=err, err_over_limit=over, ok=ok)
        print("kernel-check", json.dumps(rec), flush=True)
        results.append(rec)
        if name in ("decode", "prefill"):
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {rec}")
    return results, worst


def time_ms(torch, fn, flush, reps=25):
    """Device time of one call: median of `reps` calls, each between two
    CUDA events, L2 flushed before each (the main path reaches attention
    after a layer's weights). A device-side sleep queued first keeps the
    card busy while the host enqueues every call, so the events time the
    device's work and not the host's launch overhead; the sleep must still
    be running when the last call is queued, or the script fails."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(4e8))                 # ~0.2 s at 1.98 GHz
    slept = torch.cuda.Event()
    slept.record()
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    if slept.query():
        raise AssertionError("host fell behind the device while queueing; "
                             "the timing would include launch overhead")
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def attention_bound(B, S, Hq, Hkv, D, NB, BS, lengths, elt, dtype):
    """Least time for this call on an H100 SXM: each input byte read once
    (q, the LIVE K/V rows, tables, lengths), the output written once; the
    operations 4*D per allowed (query head, row, column) triple. Returns
    (ms, 'bytes' | 'operations')."""
    capacity = NB * BS
    lengths = np.asarray(lengths, np.int64)
    live = np.minimum(lengths + S, capacity)
    kv_bytes = 2 * int(live.sum()) * Hkv * D * elt
    io_bytes = 2 * B * S * Hq * D * elt + (B * NB + B) * 4
    pairs = sum(int(np.minimum(ln + np.arange(S) + 1, capacity).sum())
                for ln in lengths)
    flops = 4.0 * D * Hq * pairs
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(torch, pa, device):
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {}
    for name, S, lengths in (("decode", 1, decode_lengths(rng)),
                             ("prefill", 64, prefill_offsets(rng))):
        B, Hkv, G, D, BS = 8, 16, 1, 64, 32
        args = make_case(torch, B, S, Hkv, G, D, BS, list(lengths),
                         "bfloat16", device, seed=7)
        q, kp, vp, tbl, ln = args
        before = pa.paged_decode_attention.launches
        ms = time_ms(torch, lambda: pa.paged_decode_attention(*args), flush)
        launches = pa.paged_decode_attention.launches - before
        plain_ms = time_ms(torch,
                           lambda: pa.paged_decode_attention_ref(*args),
                           flush)
        # library yardstick: SDPA over the cache gathered dense (setup,
        # not timed); the port never calls it
        T = tbl.shape[1] * BS
        kd = kp[:, tbl.long()].reshape(Hkv, B, T, D).transpose(0, 1)
        vd = vp[:, tbl.long()].reshape(Hkv, B, T, D).transpose(0, 1)
        pos_q = ln.long()[:, None] + torch.arange(S, device=device)
        mask = (torch.arange(T, device=device)[None, None, :]
                <= pos_q[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask), flush)
        bound_ms, bound_by = attention_bound(B, S, Hkv * G, Hkv, D,
                                             tbl.shape[1], BS, lengths, 2,
                                             "bfloat16")
        rec = dict(shape=name, B=B, S=S, Hq=Hkv * G, Hkv=Hkv, D=D, BS=BS,
                   dtype="bfloat16", live_tokens=int(np.minimum(
                       np.asarray(lengths) + S, T).sum()),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   timed_launches=launches)
        print("kernel-time", json.dumps(rec), flush=True)
        out[name] = rec
    return out


# ----------------------------------------------------------- phase 5/6
FLASH_OUTPUTS = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}


def flash_run(fa, q, k, v, do, causal, plain=False):
    """The three kernels (or their plain versions) on one case; the backward
    takes the plain forward's out and lse, so both sides see the same saved
    inputs."""
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal)
    delta = fa.attention_delta(ro, do)
    if plain:
        out = dict(out=ro, lse=rl,
                   dq=fa.flash_attention_dq_ref(q, k, v, do, rl, delta,
                                                causal))
        out["dk"], out["dv"] = fa.flash_attention_dkv_ref(q, k, v, do, rl,
                                                          delta, causal)
        return out, delta
    o, lse = fa.flash_fwd(q, k, v, causal)
    out = dict(out=o, lse=lse, dq=fa.flash_bwd_dq(q, k, v, do, rl, delta,
                                                  causal))
    out["dk"], out["dv"] = fa.flash_bwd_dkv(q, k, v, do, rl, delta, causal)
    return out, delta


def over_limit(torch, got, ref, lim):
    """{output: (max |got - ref|, max of |got - ref| / limit)}."""
    res = {}
    for name, x in got.items():
        err = (x.float() - ref[name].float()).abs()
        ratio = torch.where(err == 0, torch.zeros_like(err),
                            err / lim[name].clamp(min=1e-30))
        res[name] = (float(err.max()), float(ratio.max()))
    return res


def flash_inputs(torch, B, S, H, Hkv, D, dtype, device, seed):
    """q, k, v, dO on the card; kv heads repeated to H as the wrapper
    repeats them (``repeat_interleave``) before the kernels."""
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=g, device=device).to(td)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=device).to(td)
            .repeat_interleave(H // Hkv, dim=2) for _ in range(2))
    return q, k, v, do


def check_flash_kernels(torch, fa, device):
    cases = [("train", 8, 1024, 16, 16, 64, True),
             ("noncausal", 2, 1024, 8, 8, 64, False),
             ("d128", 2, 512, 8, 8, 128, True),
             ("gqa", 2, 1024, 16, 4, 64, True),
             ("ragged", 2, 1000, 8, 8, 64, True),
             ("s8192", 1, 8192, 4, 4, 64, True)]
    results, worst = [], {}
    for n, (name, B, S, H, Hkv, D, causal) in enumerate(cases):
        for dtype in ("bfloat16", "float32"):
            q, k, v, do = flash_inputs(torch, B, S, H, Hkv, D, dtype, device,
                                       seed=200 + n)
            got, _ = flash_run(fa, q, k, v, do, causal)
            torch.cuda.synchronize()
            ref, delta = flash_run(fa, q, k, v, do, causal, plain=True)
            lim = fa.kernel_tolerance(q, k, v, ref, causal, dout=do,
                                      delta=delta)
            res = over_limit(torch, got, ref, lim)
            ok = (all(bool(torch.isfinite(x).all()) for x in got.values())
                  and all(r <= 1.0 for _, r in res.values()))
            rec = dict(case=name, dtype=dtype, B=B, S=S, H=H, Hkv=Hkv, D=D,
                       causal=causal, ok=ok,
                       **{f"{o}_max_abs_err": e for o, (e, _) in res.items()},
                       **{f"{o}_err_over_limit": r
                          for o, (_, r) in res.items()})
            print("flash-check", json.dumps(rec), flush=True)
            results.append(rec)
            if dtype == "bfloat16":
                for kern, outs in FLASH_OUTPUTS.items():
                    worst[kern] = max([worst.get(kern, 0.0)]
                                      + [res[o][0] for o in outs
                                         if o != "lse"])
            if not ok:
                raise AssertionError(f"flash kernel disagrees with plain: "
                                     f"{rec}")
            del got, ref, lim
    return results, worst


def flash_bounds(B, S, H, D, causal, elt=2):
    """Least time of each kernel on an H100 SXM at these shapes: each input
    read once and each output written once; 2*D operations per allowed
    (row, column) pair and product (forward 2 products, dq 3, dk/dv 4).
    Returns {kernel: (ms, 'bytes' | 'operations')}."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    tile = B * S * H * D * elt
    row = B * H * S * 4
    work = {"fwd": (2, 3 * tile + tile + row),
            "dq": (3, 4 * tile + 2 * row + tile),
            "dkv": (4, 4 * tile + 2 * row + 2 * tile)}
    out = {}
    for kern, (products, nbytes) in work.items():
        t_ops = 2.0 * D * pairs * products / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[kern] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


FLASH_TIMED_SHAPES = {"train": (8, 1024, 16, 64),   # the main path's
                      "s8192": (1, 8192, 4, 64)}    # TPU's chunked range


def time_flash(torch, fa, device):
    """Kernel, plain and library times of the three kernels (bf16, causal)
    at the training shape and at S = 8192, where the TPU ran its chunked
    backward (rows 6-7). The library yardstick is
    scaled_dot_product_attention on the same inputs ([B, H, S, D]
    contiguous copies made outside the timing): its forward for the
    forward, its one backward (dq, dk and dv together) for dq and dk/dv.
    The port never calls it. Returns {shape: {kernel: record}}."""
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {}
    for shape, (B, S, H, D) in FLASH_TIMED_SHAPES.items():
        q, k, v, do = flash_inputs(torch, B, S, H, H, D, "bfloat16", device,
                                   seed=300)
        ro, rl = fa.flash_attention_fwd_ref(q, k, v, True)
        delta = fa.attention_delta(ro, do)
        calls = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, True),
                    lambda: fa.flash_attention_fwd_ref(q, k, v, True)),
            "dq": (lambda: fa.flash_bwd_dq(q, k, v, do, rl, delta, True),
                   lambda: fa.flash_attention_dq_ref(q, k, v, do, rl, delta,
                                                     True)),
            "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, rl, delta, True),
                    lambda: fa.flash_attention_dkv_ref(q, k, v, do, rl,
                                                       delta, True)),
        }
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        for t in (qt, kt, vt):
            t.requires_grad_()
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
        bounds = flash_bounds(B, S, H, D, True)
        out[shape] = {}
        for kern, (kernel, plain) in calls.items():
            rec = dict(shape=shape, kernel=kern, B=B, S=S, H=H, D=D,
                       dtype="bfloat16", causal=True,
                       ms=time_ms(torch, kernel, flush),
                       plain_ms=time_ms(torch, plain, flush),
                       library_ms=lib_fwd if kern == "fwd" else lib_bwd,
                       library_call=("sdpa forward" if kern == "fwd" else
                                     "sdpa backward (dq, dk, dv in one "
                                     "call)"),
                       bound_ms=bounds[kern][0], bound_by=bounds[kern][1])
            print("flash-time", json.dumps(rec), flush=True)
            out[shape][kern] = rec
        del q, k, v, do, ro, rl, delta, qt, kt, vt, dot, lib_out, calls
    return out


# --------------------------------------------------------------- phase 7
def insitu_check(torch, model, cache_cls, device, C=64, slots=8):
    """Two prefill chunks of the full model per path, the second over a
    cache the first filled. On the kernel path every layer's kernel call is
    held to the plain version on the same inputs (the limit of
    ``kernel_tolerance``), and the logits to the plain attention path's. A
    control runs the kernel with each request's length one short (every
    query row misses its own key) and must fail the per-layer check."""
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(4)
    V = model.config.vocab_size
    ids = rng.integers(0, V, (slots, 2 * C))
    lens = np.full(slots, C)
    lens[2] = max(1, C * 37 // 64)              # a short chunk
    kernel = gpt_mod.paged_decode_attention

    def run(path, fault=False):
        over = []

        def checked(q, kp, vp, tbl, ln, scale=None):
            bad = (ln - 1).clamp(min=0) if fault else ln
            got = kernel(q, kp, vp, tbl, bad, scale=scale)
            args = (q, kp, vp, tbl, ln)
            ref = pa.paged_decode_attention_ref(*args, scale=scale)
            over.append(held_to_plain(torch, pa, args, got, ref, scale)[1])
            return got

        kv = cache_cls(*model._decode_cache_spec(), block_size=32,
                       num_blocks=slots * 4, dtype=torch.bfloat16,
                       device=device)
        tables = np.stack([kv.reserve(i, 2 * C) for i in range(slots)])
        gpt_mod.paged_decode_attention = checked
        try:
            first = model.chunk_logits(ids[:, :C], np.zeros(slots), lens, kv,
                                       tables, decode_kernel=path)
            second = model.chunk_logits(ids[:, C:], lens, np.full(slots, C),
                                        kv, tables, decode_kernel=path)
        finally:
            gpt_mod.paged_decode_attention = kernel
        logits = torch.stack([first, second]).float()
        if not torch.isfinite(logits).all():
            raise AssertionError(f"non-finite logits on the {path} path")
        return logits, max(over, default=None)

    plain, _ = run("plain")
    scale = float(plain.abs().max())
    rec = dict(max_abs_logit=scale, rel_tol=INSITU_REL_TOL)
    for name, fault in (("kernel", False), ("fault", True)):
        logits, over = run("kernel", fault)
        diff = float((logits - plain).abs().max())
        rec[name] = dict(
            layer_err_over_limit=over, max_abs_dlogit=diff,
            rel=diff / scale, greedy_agreement=float(
                (logits.argmax(-1) == plain.argmax(-1)).float().mean()))
    print("insitu", json.dumps(rec), flush=True)
    k, f = rec["kernel"], rec["fault"]
    if k["layer_err_over_limit"] > 1.0 or k["rel"] > INSITU_REL_TOL:
        raise AssertionError(f"kernel path drifts from plain path: {rec}")
    if f["layer_err_over_limit"] <= 1.0:
        raise AssertionError(f"the planted fault passed a check: {rec}")
    return rec


def profile_steps(torch, model, cache_cls, device, slots=8, chunk=64,
                  decode_steps=4, seed=6):
    """Where a serving step's time goes: one decode_step (``decode_steps``
    tokens per slot) and one prefill_chunk over 8 slots with 300-900
    cached tokens each, timed by the host clock without the profiler and
    then traced by torch.profiler. Reports the device's busy share (the
    sum of kernel times over the profiled wall; kernels run on one stream
    and do not overlap), the attention kernel's share of device time and
    the heaviest kernels. Device numbers are None where the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    kv = cache_cls(*model._decode_cache_spec(), block_size=32,
                   num_blocks=slots * 1024 // 32, dtype=torch.bfloat16,
                   device=device)
    tables = np.stack([kv.reserve(i, 1024) for i in range(slots)])
    lengths = rng.integers(300, 900, slots)
    V = model.config.vocab_size
    calls = {
        "decode_step": lambda: model.decode_step(
            rng.integers(0, V, slots), lengths, np.ones(slots, bool), kv,
            tables, steps=decode_steps, max_lens=lengths + decode_steps),
        "prefill_chunk": lambda: model.prefill_chunk(
            rng.integers(0, V, (slots, chunk)), lengths,
            np.full(slots, chunk), kv, tables),
    }
    out = {}
    for name, call in calls.items():
        call()                                      # warm
        t0 = time.perf_counter()
        call()                                      # ends in a host copy
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        dev_us = sum(e.self_device_time_total for e in kernels)
        attn_us = sum(e.self_device_time_total for e in kernels
                      if "paged_partials_kernel" in e.key
                      or "combine_kernel" in e.key)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        rec = dict(call=name, slots=slots, tokens=int(
                       slots * (decode_steps if name == "decode_step"
                                else chunk)),
                   wall_ms=wall * 1e3, profiled_wall_ms=prof_wall * 1e3,
                   device_ms=dev_us / 1e3 if dev_us else None,
                   kernel_launches=int(sum(e.count for e in kernels)),
                   device_busy_share=(dev_us / 1e6 / prof_wall
                                      if dev_us else None),
                   attention_share_of_device=(attn_us / dev_us
                                              if dev_us else None),
                   top_kernels=[(e.key[:80], e.count,
                                 e.self_device_time_total / 1e3)
                                for e in top])
        print("profile", json.dumps(rec), flush=True)
        out[name] = rec
    return out


def serve(torch, model, device, n_requests=12, http_requests=2,
          prompt_range=(50, 700), new_range=(16, 64), slots=8, chunk=64,
          decode_steps=4, block_size=32, max_seq_len=1024):
    """The main path: threaded requests through the continuous scheduler,
    then requests over HTTP. Returns the serving record."""
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        InferenceServer,
        PagedKVCache,
    )
    from paddle_tpu_torch.ops import paged_attention as pa

    spec = model._decode_cache_spec()
    kv = PagedKVCache(*spec, block_size=block_size,
                      num_blocks=slots * max_seq_len // block_size,
                      dtype=torch.bfloat16, device=device)
    gp = ContinuousGenerateBatchingPredictor(
        model, max_slots=slots, prefill_chunk=chunk, decode_steps=decode_steps,
        max_new_tokens=new_range[1], max_seq_len=max_seq_len, kv_cache=kv,
        device=device)
    stats = dict(prefill_s=0.0, prefill_tokens=0, prefill_calls=0,
                 decode_s=0.0, decode_tokens=0, decode_calls=0)
    pf, dc = model.prefill_chunk, model.decode_step

    def timed_prefill(chunk_ids, offsets, chunk_lens, *a, **kw):
        t0 = time.perf_counter()
        out = pf(chunk_ids, offsets, chunk_lens, *a, **kw)  # synced (.cpu)
        stats["prefill_s"] += time.perf_counter() - t0
        stats["prefill_tokens"] += int(np.sum(chunk_lens))
        stats["prefill_calls"] += 1
        return out

    def timed_decode(tokens, lengths, active, *a, steps=1, **kw):
        t0 = time.perf_counter()
        out = dc(tokens, lengths, active, *a, steps=steps, **kw)
        stats["decode_s"] += time.perf_counter() - t0
        stats["decode_tokens"] += int(np.sum(active)) * steps
        stats["decode_calls"] += 1
        return out

    model.prefill_chunk, model.decode_step = timed_prefill, timed_decode
    rng = np.random.default_rng(9)
    V = model.config.vocab_size
    plens = rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)
    plens[0], plens[1] = prompt_range
    news = rng.integers(new_range[0], new_range[1] + 1, n_requests)
    prompts = [rng.integers(0, V, n).astype(np.int64) for n in plens]
    results, errors = {}, {}

    def client(i):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_k=40)
        try:
            results[i] = gp.infer(prompts[i], timeout=600,
                                  max_new_tokens=int(news[i]), **kw)
        except Exception as e:      # reported below, fails the phase
            errors[i] = repr(e)

    srv = InferenceServer(gp, device=device, default_timeout=600).start()
    pa.paged_decode_attention.launches = 0          # main path starts here
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"requests failed: {errors}")
        http_out = []
        for j in range(http_requests):
            p = rng.integers(0, V, int(plens[j % len(plens)])).astype(
                np.int64)
            buf = io.BytesIO()
            np.savez(buf, ids=p)
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                out = np.load(io.BytesIO(r.read()))["out0"]
            http_out.append((p, out))
    finally:
        wall = time.perf_counter() - t0
        srv.stop()                                  # drains, closes gp
        model.prefill_chunk, model.decode_step = pf, dc
    launches = pa.paged_decode_attention.launches   # main path ends here
    for i, out in results.items():
        want = len(prompts[i]) + int(news[i])
        if out.shape != (want,) or not np.array_equal(out[:plens[i]],
                                                      prompts[i]):
            raise AssertionError(f"request {i}: shape {out.shape} != "
                                 f"({want},) or prompt not echoed")
        if out.min() < 0 or out.max() >= V:
            raise AssertionError(f"request {i}: token ids out of range")
    for p, out in http_out:
        if (out.shape != (len(p) + new_range[1],)
                or not np.array_equal(out[:len(p)], p)
                or out.min() < 0 or out.max() >= V):
            raise AssertionError("HTTP request: wrong length or ids")
    kv.check_conservation()
    if kv.blocks_in_use != 0:
        raise AssertionError(f"{kv.blocks_in_use} KV blocks leaked")
    snap = gp.metrics.snapshot()
    forwards = (snap.get("prefill_ticks", 0)
                + decode_steps * snap.get("decode_ticks", 0))
    expect = spec[0] * forwards
    rec = dict(requests=n_requests, http_requests=http_requests,
               completed=snap.get("completed", 0), wall_s=wall,
               prefill_tokens=stats["prefill_tokens"],
               prefill_s=stats["prefill_s"],
               prefill_tok_per_s=stats["prefill_tokens"] / stats["prefill_s"],
               decode_tokens=stats["decode_tokens"],
               decode_s=stats["decode_s"],
               decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"],
               prefill_ticks=snap.get("prefill_ticks", 0),
               decode_ticks=snap.get("decode_ticks", 0),
               kernel_launches=launches, expected_launches=expect)
    print("serving", json.dumps(rec), flush=True)
    if rec["completed"] != n_requests + http_requests:
        raise AssertionError(f"completed {rec['completed']} of "
                             f"{n_requests + http_requests}")
    if launches != expect or launches == 0:
        raise AssertionError(f"kernel launches {launches} != num_layers x "
                             f"forwards = {expect}")
    return rec


# --------------------------------------------------------------- phase 8
def flash_launches(fa):
    return {"fwd": fa.flash_fwd.launches, "dq": fa.flash_bwd_dq.launches,
            "dkv": fa.flash_bwd_dkv.launches}


def train_insitu(torch, fa, model, ids, labels):
    """One forward and backward of the model with every flash kernel call
    held to its plain version on the same inputs (the limits of
    ``kernel_tolerance``); returns {"fwd" | "bwd": worst err / limit}.
    ``fault`` plants K rolled by one position into the forward kernel, or
    lse + 0.5 into the backward kernels; both must fail the check. Then the
    first loss through the kernels against the loss through the plain
    attention, same weights and batch."""
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)

    def run(fault=None, backward=True):
        worst = {"fwd": 0.0, "bwd": 0.0}

        def fwd(q, k, v, causal=False, scale=None):
            kk = k.roll(1, dims=1) if fault == "k_roll" else k
            out, lse = kernels[0](q, kk, v, causal, scale)
            ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
            lim = fa.kernel_tolerance(q, k, v, dict(out=ro, lse=rl), causal,
                                      scale)
            res = over_limit(torch, dict(out=out, lse=lse),
                             dict(out=ro, lse=rl), lim)
            worst["fwd"] = max([worst["fwd"]] + [r for _, r in res.values()])
            return out, lse

        def bwd(kernel, plain, names):
            def call(q, k, v, dout, lse, delta, causal=False, scale=None):
                bad = lse + 0.5 if fault == "lse" else lse
                got = kernel(q, k, v, dout, bad, delta, causal, scale)
                ref = plain(q, k, v, dout, lse, delta, causal, scale)
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                refs = dict(zip(names, ref), lse=lse)
                lim = fa.kernel_tolerance(q, k, v, refs, causal, scale,
                                          dout=dout, delta=delta)
                res = over_limit(torch, dict(zip(names, got)), refs, lim)
                worst["bwd"] = max([worst["bwd"]]
                                   + [r for _, r in res.values()])
                return got if len(got) > 1 else got[0]
            return call

        fa.flash_fwd = fwd
        fa.flash_bwd_dq = bwd(kernels[1], fa.flash_attention_dq_ref, ("dq",))
        fa.flash_bwd_dkv = bwd(kernels[2], fa.flash_attention_dkv_ref,
                               ("dk", "dv"))
        try:
            if backward:
                _, loss = model(ids, labels=labels)
                loss.backward()
                model.zero_grad(set_to_none=True)
            else:
                with torch.no_grad():
                    model(ids, labels=labels)
        finally:
            fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = kernels
        return worst

    sound = run()
    k_roll = run("k_roll", backward=False)
    lse_fault = run("lse")

    def first_loss(plain):
        if plain:
            fa.flash_fwd = (lambda q, k, v, causal=False, scale=None:
                            fa.flash_attention_fwd_ref(q, k, v, causal,
                                                       scale))
        try:
            with torch.no_grad():
                return float(model(ids, labels=labels)[1].float())
        finally:
            fa.flash_fwd = kernels[0]

    loss_k, loss_p = first_loss(False), first_loss(True)
    rec = dict(sound=sound, k_rolled_fwd=k_roll["fwd"],
               lse_plus_half_bwd=lse_fault["bwd"], loss_kernel=loss_k,
               loss_plain=loss_p, loss_rel=abs(loss_k - loss_p) / abs(loss_p),
               loss_rel_tol=LOSS_REL_TOL)
    print("train-insitu", json.dumps(rec), flush=True)
    if sound["fwd"] > 1.0 or sound["bwd"] > 1.0:
        raise AssertionError(f"flash kernels drift from plain in situ: {rec}")
    if k_roll["fwd"] <= 1.0 or lse_fault["bwd"] <= 1.0:
        raise AssertionError(f"a planted fault passed the check: {rec}")
    if not rec["loss_rel"] <= LOSS_REL_TOL:
        raise AssertionError(f"kernel loss drifts from plain loss: {rec}")
    return rec


def kernel_kind(name):
    """A device kernel's kind, by its name, for the time breakdown."""
    if "flash_" in name:
        return "flash attention"
    if any(t in name for t in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matmul"
    if any(t in name for t in ("copy", "Copy", "cat", "Cat")):
        return "copy / cast"
    if "reduce" in name:
        return "reduction"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def gpt_step_flops(config, B, S):
    """Operations of one training step: 6 per parameter per token for the
    matrix products (the blocks and the tied head; the embedding lookup is
    no product), and the attention's six [S, S] products (forward 2,
    backward 4) over the causal pairs."""
    c = config
    H, D = c.num_heads, c.hidden_size // c.num_heads
    kv = c.num_kv_heads * D
    block = (c.hidden_size * (c.hidden_size + 2 * kv) + c.hidden_size ** 2
             + 3 * c.hidden_size * c.intermediate_size + 2 * c.hidden_size)
    matmul_params = c.num_layers * block + c.vocab_size * c.hidden_size
    attn = c.num_layers * 6 * 2 * D * B * H * S * (S + 1) // 2
    return 6.0 * matmul_params * B * S + attn


def train(torch, fa, device, B=8, S=1024, warmup=2, timed=8, seed=12,
          cfg=None):
    """The training main path: GPT-350M (or ``cfg``) at full width, O2
    bf16, AdamW under TrainStep, as ``bench.py`` ``_gpt_train_phase`` runs
    the JAX package."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.nn import functional as F

    cfg = cfg or gpt_350m()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, lambda logits, loss: loss, opt)
    ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    ids = torch.as_tensor(ids_np, device=device)
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device=device)
    torch.cuda.synchronize()
    print(f"train model: {cfg.num_layers} layers O2 bf16, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    insitu = train_insitu(torch, fa, model, ids, labels)

    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = 0   # main path
    fa.flash_bwd_dkv.launches = 0
    losses = [step(ids, labels=labels) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(ids, labels=labels) for _ in range(timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    launches = flash_launches(fa)                          # main path ends
    backend = F.get_last_attention_backend()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x.float()) for x in losses]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(ids, labels=labels)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    attn_us = sum(e.self_device_time_total for e in kernels
                  if "flash_" in e.key)
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # the forward and backward alone (no clip, no update), host clock
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        model(ids, labels=labels)[1].backward()
        model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    fwd_bwd_ms = (time.perf_counter() - t1) / 3 * 1e3
    flops = gpt_step_flops(cfg, B, S)
    steps = warmup + timed
    rec = dict(B=B, S=S, layers=cfg.num_layers, warmup=warmup, timed=timed,
               losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=B * S / step_s, step_flops=flops,
               bf16_peak_share=flops / step_s / PEAK_FLOPS["bfloat16"],
               max_memory_allocated=peak, flash_launches=launches,
               expected_launches_each=cfg.num_layers * steps,
               attention_backend=backend,
               profiled_wall_ms=prof_wall * 1e3,
               device_ms=dev_us / 1e3 if dev_us else None,
               kernel_launches=int(sum(e.count for e in kernels)),
               device_busy_share=(dev_us / 1e6 / prof_wall
                                  if dev_us else None),
               attention_share_of_device=(attn_us / dev_us
                                          if dev_us else None),
               device_ms_by_kind=by_kind, fwd_bwd_ms=fwd_bwd_ms,
               top_kernels=[(e.key[:80], e.count,
                             e.self_device_time_total / 1e3) for e in top])
    print("train", json.dumps(rec), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if any(n != cfg.num_layers * steps for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.num_layers} layers x {steps} steps each")
    if backend != "kernel":
        raise AssertionError(f"attention backend {backend!r} != 'kernel'")
    del model, opt, step
    torch.cuda.empty_cache()
    return rec, insitu


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the full record to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on a GPU")
    device = "cuda"
    card = card_line()
    print("card:", card, flush=True)

    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_350m
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    # the plain versions' f32 products stay in full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    log = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, rec in log.items():
        regs = [ln.strip() for ln in rec["ptxas"].splitlines()
                if "registers" in ln]
        print(f"build {name}: {rec['seconds']:.1f} s nvcc; "
              f"{len(regs)} kernels; e.g. {regs[:2]}", flush=True)
    print(f"build: {build_s:.1f} s total", flush=True)

    checks, worst = check_kernels(torch, pa, device)
    timing = time_kernels(torch, pa, device)
    flash_checks, flash_worst = check_flash_kernels(torch, fa, device)
    flash_timing = time_flash(torch, fa, device)

    t0 = time.perf_counter()
    model = GPTForCausalLM(gpt_350m(), device=device, dtype=torch.bfloat16,
                           seed=0)
    torch.cuda.synchronize()
    print(f"model: GPT-350M bf16, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    insitu = insitu_check(torch, model, PagedKVCache, device)
    steps = profile_steps(torch, model, PagedKVCache, device)
    serving = serve(torch, model, device)
    print(f"serving on {card}: prefill {serving['prefill_tok_per_s']:.0f} "
          f"tok/s, decode {serving['decode_tok_per_s']:.0f} tok/s",
          flush=True)
    del model
    torch.cuda.empty_cache()
    training, train_checks = train(torch, fa, device)
    print(f"training on {card}: {training['step_ms']:.1f} ms/step, "
          f"{training['tokens_per_s']:.0f} tok/s, "
          f"{training['bf16_peak_share']:.3f} of the bf16 peak", flush=True)

    d = timing["decode"]
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:245",
        "launches": serving["kernel_launches"],
        "max_abs_err": worst["bfloat16"],
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "prefill": {k: timing["prefill"][k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
    }]
    src = "paddle_tpu/ops/pallas/flash_attention.py"
    for kern, name, replaces, also in (
            ("fwd", "flash_attention_fwd", f"{src}:89", []),
            ("dq", "flash_attention_dq", f"{src}:166", [f"{src}:230"]),
            ("dkv", "flash_attention_dkv", f"{src}:196", [f"{src}:272"])):
        t = flash_timing["train"][kern]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "also_replaces": also,
            "launches": training["flash_launches"][kern],
            "max_abs_err": flash_worst[kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_call": t["library_call"],
            "s8192": {k: flash_timing["s8192"][kern][k] for k in
                      ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")}})
    record = dict(card=card, build_s=build_s, checks=checks, timing=timing,
                  insitu=insitu, profile=steps, serving=serving,
                  flash_checks=flash_checks, flash_timing=flash_timing,
                  train_insitu=train_checks, training=training,
                  kernels=kernels)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
