#!/usr/bin/env python3
"""Run two checkouts' whole ``chip_smoke.py`` against each other on one card.

    python3 tools/smoke_ab.py OTHER_ROOT [--out DIR] [--json PATH]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a git-ignored directory. Each
checkout's own ``chip_smoke.py`` runs from its own root, in four turns in
the order other, this, this, other, each a process of its own that builds
and imports that checkout's package, with ``--json`` into DIR (default
``chiprun_out/smoke_ab``; each turn's output beside it). Then every number
the two sides' records share under the same path whose key names a time,
a rate or a share (``*_ms``, ``*_s``, ``ms``, ``*per_s``, ``*_share``) is
compared: each side's two turns, this side's mean over the other's, the
larger of the two sides' turn-to-turn spreads (|difference| over the
mean), and whether the sides' turns do not overlap ("apart": every turn
of one side above every turn of the other). Prints the card, each turn's
exit code and phase seconds, the number of readings compared and apart,
the readings in WATCH, and the 40 readings apart by the most. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("other", "this", "this", "other")
SUFFIXES = ("_ms", "_s", "per_s", "_share")
# the host-bound eager readings and captures that tell the two apart
WATCH = (
    "training.body_step_ms", "training.step_ms",
    "training.body.device_busy_share",
    "train_recipes.o2_f16_grad_scaler.step_ms",
    "train_recipes.o2_f16_grad_scaler.device_busy_share",
    "train_recipes.dropout_0.1.capture_ms",
    "profile.decode_step.body.wall_ms", "profile.verify_step.body.wall_ms",
    "serving.prefill_tok_per_s", "serving.decode_tok_per_s",
    "llama_serve.profile.decode_step.body.wall_ms",
    "llama_serve.profile.prefill_chunk.body.wall_ms",
    "llama_serve.profile.verify_step.body.wall_ms",
    "llama_serve.profile.decode_step.replay.graph_launch_ms",
    "llama_serve.serving.prefill_tok_per_s",
    "llama_serve.serving.prefill_capture_s",
    "llama_serve.serving.runners.prefill_chunk.capture_s",
    "llama_train.capture_ms", "gpt3_1p3b.training.capture_ms",
)


def readings(rec, path=""):
    """{dotted path: number} of ``rec``'s time, rate and share leaves."""
    out = {}
    if isinstance(rec, dict):
        for k, v in rec.items():
            out.update(readings(v, f"{path}.{k}" if path else str(k)))
    elif (isinstance(rec, (int, float)) and not isinstance(rec, bool)
          and (path.endswith(SUFFIXES) or path.endswith(".ms"))):
        out[path] = float(rec)
    return out


def compare(turns):
    """{path: {"other": [..], "this": [..], "ratio", "spread", "apart"}}
    over the paths every turn's record holds."""
    flat = [(side, readings(rec)) for side, rec in turns]
    common = set.intersection(*(set(r) for _, r in flat))
    out = {}
    for path in sorted(common):
        by = {s: [r[path] for side, r in flat if side == s]
              for s in ("other", "this")}
        mean = {s: sum(v) / len(v) for s, v in by.items()}
        spread = max((max(v) - min(v)) / abs(mean[s]) if mean[s] else 0.0
                     for s, v in by.items())
        apart = (min(by["this"]) > max(by["other"])
                 or max(by["this"]) < min(by["other"]))
        out[path] = dict(other=by["other"], this=by["this"],
                         ratio=(mean["this"] / mean["other"]
                                if mean["other"] else None),
                         spread=spread, apart=apart)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", metavar="OTHER_ROOT")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "smoke_ab"))
    ap.add_argument("--json", help="write the comparison to this file")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card_line()
    print("card:", card, flush=True)
    roots = {"this": ROOT, "other": os.path.abspath(args.other)}
    os.makedirs(args.out, exist_ok=True)
    turns = []
    for i, side in enumerate(ORDER):
        path = os.path.join(args.out, f"turn{i}_{side}")
        with open(path + ".out", "w") as out, \
                open(path + ".err", "w") as err:
            rc = subprocess.run(
                [sys.executable, "chip_smoke.py", "--json", path + ".json"],
                cwd=roots[side], stdout=out, stderr=err,
                timeout=1500).returncode
        if rc or not os.path.exists(path + ".json"):
            raise SystemExit(f"smoke_ab: the {side} turn {i} exited {rc}; "
                             f"see {path}.err")
        with open(path + ".json") as f:
            rec = json.load(f)
        turns.append((side, rec))
        print(f"turn {i} {side}: exit {rc}, phases "
              f"{json.dumps(rec.get('phase_s'))}", flush=True)
    table = compare(turns)
    apart = {k: v for k, v in table.items() if v["apart"]}
    print(f"{len(table)} readings compared, {len(apart)} with the sides' "
          f"turns apart", flush=True)
    for k in WATCH:
        if k in table:
            print(f"watch {k}: {json.dumps(table[k])}", flush=True)
    for k in sorted(apart, key=lambda k: -abs(
            (apart[k]["ratio"] or 1.0) - 1.0))[:40]:
        print(f"apart {k}: {json.dumps(apart[k])}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, order=ORDER, table=table), f,
                      indent=1)


if __name__ == "__main__":
    main()
