#!/usr/bin/env python3
"""Time two checkouts' host-bound eager steps against each other, in many
short alternating windows on one card.

    python3 tools/eager_ab.py OTHER_ROOT [--pairs N] [--json PATH]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a git-ignored directory; it may be
this root, the A/A run that shows the comparison's own floor. Three
workloads, each as ``chip_smoke.py`` runs it eagerly on GPT-350M from the
same seeds (B 8, S 1024 for training): ``train_body``, the O2 bf16
``TrainStep`` (AdamW lr 1e-4, weight decay 0.01) run as bodies
(``_eager()``); ``f16_scaler_step``, the O2 f16 eager step under
``GradScaler`` (forward, scaled backward, ``scaler.step``,
``clear_grad``); and the paged step programs in bf16 over 8 slots with
300-900 cached tokens (``decode_step`` of 4 tokens, ``prefill_chunk`` of
64 rows, ``verify_step`` of 4 drafts), each run as its body
(``run._eager()``). For each workload, two sessions of N / 2 pairs (N
default 12): one worker process per checkout, importing that checkout's
``paddle_tpu_torch``, both alive through the session, the other side's
started first in the first session and this side's in the second; in
each pair the other side's window comes first in even pairs and this
side's in odd ones, a window being 3 steps (4 calls of each step
program) timed on the host clock between two synchronisations. Host speed
drifts within a call (other tenants share the host); windows seconds
apart see the same host, so the comparison reads the pairs, not two long
runs. Prints the card, each pair, each session's ratios, and, per form
over all its pairs, each side's quartiles (ms), this side's median over
the other's and the pairs this side took longer in. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the forms, by the workload a worker builds for them
GROUPS = {"train": ("train_body",), "f16_scaler": ("f16_scaler_step",),
          "serve": ("decode_step", "prefill_chunk", "verify_step")}
FORMS = tuple(f for forms in GROUPS.values() for f in forms)


def _timed(torch, fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _train(torch, P, cfg, ids, labels):
    """window() of the GPT-350M O2 bf16 TrainStep run as bodies."""
    model = P.models.gpt.GPTForCausalLM(cfg, device="cuda", seed=12)
    P.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(),
                            weight_decay=0.01, multi_precision=True)
    step = P.jit.TrainStep(model, lambda logits, loss: loss, opt)

    def window():
        with step._eager():
            return {"train_body": _timed(
                torch, lambda: step(ids, labels=labels), 3)}

    return window


def _f16_scaler(torch, P, cfg, ids, labels):
    """window() of the O2 f16 eager step under GradScaler (forward,
    ``scaler.scale(loss).backward()``, ``scaler.step``, ``clear_grad``)."""
    model = P.models.gpt.GPTForCausalLM(cfg, device="cuda", seed=12)
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(), weight_decay=0.01)
    P.amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = P.amp.GradScaler(init_loss_scaling=1024.0)

    def one():
        _, loss = model(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()

    return lambda: {"f16_scaler_step": _timed(torch, one, 3)}


def _serve(torch, P, cfg):
    """window() of the paged step programs' bodies."""
    serve = P.models.gpt.GPTForCausalLM(cfg, device="cuda",
                                        dtype=torch.bfloat16, seed=0)
    slots, chunk, steps, k = 8, 64, 4, 4
    rng = np.random.default_rng(6)
    kv = P.inference.PagedKVCache(
        *serve._decode_cache_spec(), block_size=32,
        num_blocks=slots * 1024 // 32, dtype=torch.bfloat16, device="cuda")
    tables = np.stack([kv.reserve(i, 1024) for i in range(slots)])
    lengths = rng.integers(300, 900, slots)
    V = cfg.vocab_size
    tok = rng.integers(0, V, slots)
    chunk_ids = rng.integers(0, V, (slots, chunk))
    vchunk = rng.integers(0, V, (slots, k + 1))
    every = np.ones(slots, bool)
    programs = {
        "decode_step": (
            lambda: serve.decode_step(tok, lengths, every, kv, tables,
                                      steps=steps, max_lens=lengths + steps),
            lambda: serve.compiled_decode_step_runner(slots, steps)),
        "prefill_chunk": (
            lambda: serve.prefill_chunk(chunk_ids, lengths,
                                        np.full(slots, chunk), kv, tables),
            lambda: serve.compiled_prefill_chunk_runner(slots, chunk)),
        "verify_step": (
            lambda: serve.verify_step(vchunk, lengths, np.full(slots, k),
                                      every, kv, tables,
                                      max_lens=lengths + k + 1),
            lambda: serve.compiled_verify_step_runner(slots, k + 1)),
    }
    runners = {}
    for name, (call, runner) in programs.items():
        call()                          # the first call: body, then capture
        runners[name] = runner()

    def window():
        out = {}
        for name, (call, _) in programs.items():
            with runners[name]._eager():
                out[name] = _timed(torch, call, 4)
        return out

    return window


def worker(package_root, group):
    """Build ``group``'s workload from ``package_root``'s package, then
    answer each "go" line on stdin with one JSON line of {form: ms}."""
    sys.path.insert(0, os.path.abspath(package_root))
    import torch

    import paddle_tpu_torch as P
    import paddle_tpu_torch.inference  # noqa: F401
    import paddle_tpu_torch.models.gpt  # noqa: F401

    if not torch.cuda.is_available():
        raise SystemExit("eager_ab: no CUDA device")
    cfg = P.models.gpt.gpt_350m()
    ids_np = np.random.default_rng(12).integers(0, cfg.vocab_size, (8, 1024))
    ids = torch.as_tensor(ids_np, device="cuda")
    labels = torch.as_tensor(np.roll(ids_np, -1, axis=1), device="cuda")
    window = (_serve(torch, P, cfg) if group == "serve" else
              {"train": _train, "f16_scaler": _f16_scaler}[group](
                  torch, P, cfg, ids, labels))
    window()                            # warm-up
    print("READY " + os.path.dirname(P.__file__), flush=True)
    for line in sys.stdin:
        if line.strip() != "go":
            break
        print("AB " + json.dumps(window()), flush=True)


def _read(proc, prefix):
    while True:
        line = proc.stdout.readline()
        if not line:
            raise SystemExit(f"eager_ab: a worker ended: {proc.args}")
        if line.startswith(prefix):
            return line[len(prefix):].strip()


def summarise(windows):
    """{form: {"this": [q1, median, q3], "other": [...], "ratio",
    "this_slower_pairs", "pairs"}} from ``windows`` = [(other, this)]."""
    out = {}
    for form in [f for f in FORMS if f in windows[0][0]]:
        o = np.array([w[0][form] for w in windows])
        t = np.array([w[1][form] for w in windows])
        out[form] = dict(
            other=[float(v) for v in np.percentile(o, [25, 50, 75])],
            this=[float(v) for v in np.percentile(t, [25, 50, 75])],
            ratio=float(np.median(t) / np.median(o)),
            this_slower_pairs=int((t > o).sum()), pairs=len(windows))
    return out


def run_session(roots, group, start, pairs, first_pair):
    """``pairs`` pairs of windows of ``group`` from one worker per side,
    the workers started in the order ``start``; [(other's, this's)]."""
    procs, windows = {}, []
    try:
        for side in start:
            procs[side] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 roots[side], "--group", group], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
            pkg = _read(procs[side], "READY ")
            if os.path.realpath(pkg) != os.path.realpath(
                    os.path.join(roots[side], "paddle_tpu_torch")):
                raise SystemExit(f"eager_ab: the {side} worker imported "
                                 f"another checkout's package")
        for i in range(first_pair, first_pair + pairs):
            order = ("other", "this") if i % 2 == 0 else ("this", "other")
            got = {}
            for side in order:
                procs[side].stdin.write("go\n")
                procs[side].stdin.flush()
                got[side] = json.loads(_read(procs[side], "AB "))
            windows.append((got["other"], got["this"]))
            print(f"{group} pair {i} ({start[0]} started first, {order[0]} "
                  f"first): "
                  + json.dumps({s: {f: round(v, 3) for f, v in got[s].items()}
                                for s in ("other", "this")}), flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.stdin.close()
                p.wait(timeout=120)
    return windows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", metavar="OTHER_ROOT")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--json", help="write the record to this file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--group", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.group)
        return
    if not args.other:
        ap.error("OTHER_ROOT is required")
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card_line()
    print("card:", card, flush=True)
    roots = {"this": ROOT, "other": os.path.abspath(args.other)}
    summary, sessions = {}, []
    for group in GROUPS:
        windows = []
        # each side's worker started first in one session (the order of
        # the two processes' start on one card is not neutral)
        for start in (("other", "this"), ("this", "other")):
            got = run_session(roots, group, start, args.pairs // 2,
                              len(windows))
            sessions.append(dict(group=group, started_first=start[0],
                                 windows=got, summary=summarise(got)))
            windows += got
        summary.update(summarise(windows))
    for sess in sessions:
        print(f"{sess['group']} session, {sess['started_first']} started "
              f"first: " + json.dumps({f: round(r["ratio"], 4)
                                       for f, r in sess["summary"].items()}),
              flush=True)
    for form, rec in summary.items():
        print(f"{form}: {json.dumps(rec)}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, sessions=sessions, summary=summary), f,
                      indent=1)


if __name__ == "__main__":
    main()
