#!/usr/bin/env python3
"""Time variants of the dense kernel's decode form, and its splits, on one
card.

    python3 tools/dense_kernel_sweep.py [--json PATH]

Builds ``paddle_tpu_torch/csrc/decode_attention.cu`` as it stands
(``base``) and three variants of its decode form, each with one constant
changed: a ring of 6 or 8 stages instead of 4 (``ring6``, ``ring8``; bf16 at
D = 64) and 128-column tiles instead of 64 (``cols128``; the launch config
then counts tiles of 128 columns). All four ``nvcc`` runs start together,
into ``paddle_tpu_torch/_build/sweep/``. Then, on bf16 caches of 16 heads
of 64 (GPT-350M's attention):

* every variant at three decode shapes: B = 8 at lengths 512-639 of
  T = 640 (generate()'s decode), B = 8 at T - 128 .. T - 1 of T = 2560 (a
  longer cache), and B = 1 at 4000 of T = 4096 (split); in two rounds,
  variants in order then reversed, the mean of each variant's two times;
* the source as it stands at every tiles-per-split of seven shapes, the
  launch config's own choice marked: the two decode shapes at B = 8 and
  B = 1 above, B = 1 at 600 of T = 640, generate()'s prefill (B = 8,
  S = 512 at 0, T = 640), B = 1 prefills of 64 rows at 1984 of T = 2048
  and of 512 rows at 0 of T = 640.

Each call is first held to ``decode_attention_ref`` within
``kernel_tolerance``; times are ``chip_smoke.time_ms`` (CUDA events,
median of 25, L2 flushed). Two yardsticks of what that timing can see
come with them: a kernel that writes 16 floats, and at each decode shape
one ``torch.sum`` over as many bytes as its bound counts. Prints the
card, each variant's ``ptxas`` registers and spill, and one line per
time. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RING = "static constexpr int kStages = sizeof(T) * D <= 128 ? 4 : 3;"
DECODE_FROM = "constexpr int kWarpCols = kCols / kWarps;"
DECODE_TO = "// " + "-" * 57 + " prefill form"
# (name, B, S, T, lengths); "end": B lengths drawn from [T - 128, T)
DECODE_SHAPES = (("decode B8 T640", 8, 1, 640, "end"),
                 ("decode B8 T2560", 8, 1, 2560, "end"),
                 ("decode B1 T4096", 1, 1, 4096, [4000]))
SPLIT_SHAPES = DECODE_SHAPES + (
    ("decode B1 T640", 1, 1, 640, [600]),
    ("prefill B8 S512 T640", 8, 512, 640, [0] * 8),
    ("prefill B1 S64 T2048", 1, 64, 2048, [1984]),
    ("prefill B1 S512 T640", 1, 512, 640, [0]))


def variant_sources(src):
    """{name: (source text, tile columns)} of the variants."""
    if RING not in src or DECODE_FROM not in src or DECODE_TO not in src:
        raise SystemExit("dense_kernel_sweep: the decode form's constants "
                         "moved; update the variants")
    i, j = src.index(DECODE_FROM), src.index(DECODE_TO)
    cols128 = (src[:i] + "constexpr int kDecCols = 128;\n"
               + src[i:j].replace("kCols", "kDecCols") + src[j:])
    return {"base": (src, 64),
            "ring6": (src.replace(RING, RING.replace("? 4", "? 6")), 64),
            "ring8": (src.replace(RING, RING.replace("? 4", "? 8")), 64),
            "cols128": (cols128, 128)}


def build(variants, cs, _build):
    """{name: ctypes library}, every variant compiled in parallel."""
    out_dir = os.path.join(ROOT, "paddle_tpu_torch", "_build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, _) in variants.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"dense_kernel_sweep: nvcc failed for {name}:\n"
                             f"{log}")
        print("ptxas", name, [x for x in cs.ptxas_summary(log)
                              if "dense_decode_kernel<bf16" in x[0]],
              flush=True)
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in _build.SOURCES[
                "decode_attention"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def shape_case(torch, cs, B, S, T, lengths):
    """Seeded bf16 inputs of one shape and its lengths."""
    if lengths == "end":
        lengths = np.random.default_rng(T).integers(T - 128, T, B)
    lengths = np.asarray(lengths)
    return cs.dense_case(torch, B, S, 16, 1, 64, T, lengths, "bfloat16",
                         "cuda", seed=7), lengths


def timed(torch, cs, da, args, flush):
    """Hold one call to the plain version, then time it."""
    got = da.decode_attention(*args)
    ref = da.decode_attention_ref(*args)
    limit = da.kernel_tolerance(*args, ref)
    if not bool(((got.float() - ref.float()).abs() <= limit).all()):
        raise SystemExit("dense_kernel_sweep: a call disagrees with the "
                         "plain version")
    return cs.time_ms(torch, lambda: da.decode_attention(*args), flush)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the record to this file")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        raise SystemExit("dense_kernel_sweep: no CUDA device")
    card = cs.card_line()
    print("card:", card, flush=True)
    with open(_build.CSRC / "decode_attention.cu") as f:
        variants = variant_sources(f.read())
    libs = build(variants, cs, _build)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    config, cols = da.kernel_launch_config, da._COLS
    rec = {"card": card, "variants": {}, "splits": {}, "yardsticks": {
        "write 16 floats": cs.time_ms(
            torch, torch.zeros(16, device="cuda").zero_, flush)}}
    try:
        for shape, B, S, T, lens in DECODE_SHAPES:
            case, lengths = shape_case(torch, cs, B, S, T, lens)
            bound = cs.dense_bound(B, S, 16, 16, 64, T, lengths, 2,
                                   "bfloat16")[0]
            live = int(np.minimum(lengths + S, T).sum())   # as the bound
            buf = torch.ones((4 * live * 16 * 64 + 4 * B * S * 16 * 64) // 4,
                             device="cuda")
            rec["yardsticks"][f"{shape} sum of {buf.nbytes} bytes"] = (
                cs.time_ms(torch, buf.sum, flush))
            del buf
            times = {n: [] for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    _build._libs["decode_attention"] = libs[name]
                    da._COLS = variants[name][1]
                    times[name].append(timed(torch, cs, da, case, flush))
            for name, ts in times.items():
                da._COLS = variants[name][1]
                r = dict(ms=float(np.mean(ts)), runs=ts, bound_ms=bound,
                         config=list(config(B, S, 1, 16, T)))
                rec["variants"][f"{shape} {name}"] = r
                print("variant", shape, name, json.dumps(r), flush=True)
        _build._libs["decode_attention"] = libs["base"]
        da._COLS = cols
        for shape, B, S, T, lens in SPLIT_SHAPES:
            case, _ = shape_case(torch, cs, B, S, T, lens)
            own = config(B, S, 1, 16, T)
            tiles = -(-T // cols)
            for tps in sorted({1, 2, 4, 8, 16, tiles, own.tiles_per_split}):
                if tps > tiles:
                    continue
                cfg = da.LaunchConfig(own.form, own.rows, tps,
                                      -(-tiles // tps))
                da.kernel_launch_config = lambda *a, cfg=cfg, **k: cfg
                r = dict(tiles_per_split=tps, splits=cfg.splits,
                         ms=timed(torch, cs, da, case, flush),
                         chosen=tps == own.tiles_per_split)
                da.kernel_launch_config = config
                rec["splits"][f"{shape} tps={tps}"] = r
                print("splits", shape, json.dumps(r), flush=True)
    finally:
        da.kernel_launch_config, da._COLS = config, cols
        _build._libs.pop("decode_attention", None)
    print("yardsticks", json.dumps(rec["yardsticks"]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
