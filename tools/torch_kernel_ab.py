#!/usr/bin/env python3
"""Time two checkouts' CUDA kernels against each other on one card.

    python3 tools/torch_kernel_ab.py OTHER_ROOT [--json PATH]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a git-ignored directory. The kernel
timing phases of ``chip_smoke.py`` (4, 6, 9 and 13: the paged, dense, flash
and FlashMask kernels at their timed shapes) run in four turns, in the
order other, this, this, other, each in a process of its own that imports
``paddle_tpu_torch`` from one checkout and builds that checkout's kernels
from its own sources. Both sides are timed by this checkout's
``chip_smoke.py``, so only the kernels differ. Prints the card, each turn's
times, and each kernel and shape's mean time per side with this side's over
the other's. Needs one CUDA card. ``drive`` is the A/B command line that
``tools/train_step_ab.py`` shares.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("other", "this", "this", "other")


def turn(package_root):
    """{kernel and shape: ms} of the kernels of ``package_root``."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(package_root))  # ahead of ROOT
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"package": os.path.dirname(paddle_tpu_torch.__file__)}
    for shape, rec in chip_smoke.time_kernels(torch, pa, "cuda").items():
        out[f"paged {shape}"] = rec["ms"]
    for shape, rec in chip_smoke.time_dense_kernels(torch, da,
                                                    "cuda").items():
        out[f"dense {shape}"] = rec["ms"]
    for shape, recs in chip_smoke.time_flash(torch, fa, "cuda").items():
        for kern, rec in recs.items():
            out[f"flash {kern} {shape}"] = rec["ms"]
    for kern, rec in chip_smoke.time_flashmask(torch, fa, "cuda").items():
        out[f"flashmask {kern}"] = rec["ms"]
        out[f"flash {kern} unmasked s8192 h16"] = rec["unmasked_ms"]
    return out


def drive(turn, tool_file, description):
    """The command line of an A/B tool: ``tool_file OTHER_ROOT [--json
    PATH]`` runs ``turn(root)`` (a JSON-able dict holding ``package``, the
    package directory it imported) in four processes of ``tool_file --turn
    ROOT``, in ``ORDER``; then, per key, each side's mean of numbers and
    this side's over the other's, and whether every turn's lists (losses)
    are equal bit for bit. Prints the card and each turn's record."""
    name = os.path.splitext(os.path.basename(tool_file))[0]
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("other", nargs="?", metavar="OTHER_ROOT")
    ap.add_argument("--json", help="write the record to this file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print("AB " + json.dumps(turn(args.turn)), flush=True)
        return
    if not args.other:
        ap.error("OTHER_ROOT is required")
    sys.path.insert(0, ROOT)
    import chip_smoke
    card = chip_smoke.card_line()
    print("card:", card, flush=True)
    roots = {"this": ROOT, "other": os.path.abspath(args.other)}
    turns = []
    for side in ORDER:
        r = subprocess.run([sys.executable, os.path.abspath(tool_file),
                            "--turn", roots[side]], capture_output=True,
                           text=True, timeout=1200)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
        if r.returncode or not lines:
            print(r.stdout[-4000:], r.stderr[-4000:])
            raise SystemExit(f"{name}: the {side} turn failed")
        rec = json.loads(lines[-1][3:])
        want = os.path.join(roots[side], "paddle_tpu_torch")
        if os.path.realpath(rec.pop("package")) != os.path.realpath(want):
            raise SystemExit(f"{name}: the {side} turn imported "
                             f"another checkout's package")
        turns.append((side, rec))
        print(side, json.dumps(rec), flush=True)
    summary, lists = {}, []
    for key in dict.fromkeys(k for _, rec in turns for k in rec):
        vals = [(s, rec[key]) for s, rec in turns if key in rec]
        if isinstance(vals[0][1], list):
            lists += [v for _, v in vals]
            continue
        mean = {side: float(np.mean([v for s, v in vals if s == side]))
                if any(s == side for s, _ in vals) else None
                for side in ("this", "other")}
        summary[key] = dict(this_ms=mean["this"], other_ms=mean["other"])
        if None not in mean.values():
            summary[key]["ratio"] = mean["this"] / mean["other"]
        print(f"{key}: {json.dumps(summary[key])}", flush=True)
    record = dict(card=card, order=ORDER, turns=turns, summary=summary)
    if lists:
        record["lists_equal"] = all(v == lists[0] for v in lists)
        print("lists equal in every turn:", record["lists_equal"],
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    drive(turn, __file__, __doc__.splitlines()[0])
