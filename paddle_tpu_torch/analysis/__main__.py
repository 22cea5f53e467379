"""``python -m paddle_tpu_torch.analysis`` — lint the zoo programs, the
compile surface, the HBM residency plan, the collectives of the
tensor-parallel step programs and the port's own threading discipline
(the counterpart of ``paddle_tpu/analysis/__main__.py``).

Exit status is the gate: 0 when every zoo program is clean at high
severity AND the thread lint over the port's source reports no
un-allowlisted high finding (allowlisted findings are printed with their
reason, not hidden), 1 otherwise, 2 on a usage error. ``--json`` emits one
object with the findings by program.

``--programs a,b`` restricts to a zoo subset; ``--surface [PATH]`` runs
only the compile-surface lint (strict fixture mode over PATH: a
generation-like ``.py``, a ``{"configs","manifest"}`` ``.json``, or a
directory of either; the real tree without PATH); ``--manifest [CONFIG]``
prints the derived program inventory as JSON (all shipped serving
configs, one by name, or a ServingConfig ``.json``); ``--hbm [NAME|PATH]``
runs only the residency lint (the smoke plan's table and rules, for one
shipped config by NAME, or strict fixture mode over a DeploymentPlan
``.json`` / ``make_program()`` ``.py`` / directory PATH);
``--threads [PATH]`` runs only the thread lint (over PATH, a file or a
directory with every module treated as runtime: the seeded-fixture mode;
without PATH over the ``paddle_tpu_torch`` package); ``--comms
[NAME|PATH]`` runs only the comms lint (the step programs traced at
tp = 2 over a fake process group, their collective table and the five
rules, for one step path by NAME, or strict fixture mode over a
``make_program()`` ``.py`` / comms-surface ``.json`` / directory PATH).
``--device`` picks where the zoo is built and traced (default: the card
when there is one, else the CPU). The full self-check runs the thread
lint too and ends with the stale-allowlist audit of every builtin list.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _print_manifest(spec=None) -> int:
    from .compilesurface import (CompileSurfaceError, ProgramManifest,
                                 ServingConfig, default_serving_configs,
                                 extract_key_schemas)

    if spec is None:
        configs = list(default_serving_configs())
    elif os.path.isfile(spec):
        with open(spec, "r") as fh:
            obj = json.load(fh)
        raw = obj if isinstance(obj, list) else obj.get("configs", [obj])
        configs = [ServingConfig.from_json(c) for c in raw]
    else:
        configs = [c for c in default_serving_configs() if c.name == spec]
        if not configs:
            print(f"unknown serving config {spec!r}; shipped: "
                  f"{[c.name for c in default_serving_configs()]} "
                  "(or pass a ServingConfig .json file)", file=sys.stderr)
            return 2
    schemas = extract_key_schemas()
    try:
        per_config = {c.name: [list(k) for k in c.program_keys(schemas)]
                      for c in configs}
    except CompileSurfaceError as e:
        print(f"key derivation failed: {e}", file=sys.stderr)
        return 1
    manifest = ProgramManifest.from_configs(configs, schemas=schemas,
                                            name="derived")
    print(json.dumps({
        "configs": [c.to_json() for c in configs],
        "programs": per_config,
        "manifest": manifest.to_json(),
    }, indent=2, default=str))
    return 0


def _thread_report(path=None):
    from .threads import analyze_threads, thread_lint_paths

    if path is None:
        return analyze_threads()
    paths = [path] if os.path.isfile(path) else thread_lint_paths(path)
    # explicit paths are fixture/audit mode: everything is runtime-strict
    return analyze_threads(paths=paths, runtime_modules=("*",))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="Graph lint over the bundled zoo programs (GPT/ResNet "
                    "train steps, dense and paged decode, the continuous "
                    "step programs at tp 1 and 2) plus the compile-"
                    "surface, HBM residency, comms and thread lints.")
    parser.add_argument("--self-check", action="store_true",
                        help="lint the zoo, exit non-zero on any "
                             "high-severity finding (the default)")
    parser.add_argument("--programs", default=None,
                        help="comma-separated subset of zoo programs")
    parser.add_argument("--threads", nargs="?", const="", default=None,
                        metavar="PATH",
                        help="run ONLY the thread lint: over PATH (file or "
                             "directory, runtime severities everywhere — "
                             "the seeded-fixture mode) or the "
                             "paddle_tpu_torch package")
    parser.add_argument("--comms", nargs="?", const="", default=None,
                        metavar="NAME|PATH",
                        help="run ONLY the comms lint: the step programs "
                             "traced at tp 2, their collective table and "
                             "the five rules (one step path by NAME: "
                             "prefill_chunk, decode_step, verify_step), or "
                             "strict fixture mode over PATH")
    parser.add_argument("--surface", nargs="?", const="", default=None,
                        metavar="PATH",
                        help="run ONLY the compile-surface lint: strict "
                             "fixture mode over PATH, or the real tree")
    parser.add_argument("--hbm", nargs="?", const="", default=None,
                        metavar="NAME|PATH",
                        help="run ONLY the HBM residency lint: the smoke "
                             "plan's table + rules (one shipped config by "
                             "NAME), or strict fixture mode over PATH")
    parser.add_argument("--manifest", nargs="?", const="", default=None,
                        metavar="CONFIG",
                        help="print the derived step-program inventory as "
                             "JSON and exit")
    parser.add_argument("--device", default=None,
                        help="cpu | cuda (default: the card when there is "
                             "one, else the CPU)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON object instead of text")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    from .rules import RULES

    if args.list_rules:
        from .comms import COMMS_RULES
        from .compilesurface import SURFACE_RULES
        from .hbm import HBM_RULES
        from .threads import THREAD_RULES

        for rule_id, fn in RULES.items():
            doc = (fn.__doc__ or "").strip().split("\n")[0]
            print(f"{rule_id:18s} {doc}")
        for rule_id, doc in THREAD_RULES.items():
            print(f"{rule_id:18s} [threads] {doc}")
        for rule_id, doc in SURFACE_RULES.items():
            print(f"{rule_id:18s} [surface] {doc.split(chr(10))[0]}")
        for rule_id, doc in HBM_RULES.items():
            print(f"{rule_id:18s} [hbm] {doc.split(chr(10))[0]}")
        for rule_id, doc in COMMS_RULES.items():
            print(f"{rule_id:18s} [comms] {doc.split(chr(10))[0]}")
        return 0

    if args.manifest is not None:
        return _print_manifest(args.manifest or None)

    reports, tables = [], []
    if args.comms is not None:
        from .comms import (_STEP_PATHS, analyze_step_comms,
                            comms_fixture_reports, render_comms_table,
                            step_comms_surfaces)

        if args.comms and os.path.exists(args.comms):
            reports.extend(comms_fixture_reports(args.comms))
        else:
            paths = None
            if args.comms:
                if args.comms not in _STEP_PATHS:
                    print(f"unknown step path {args.comms!r}; available: "
                          f"{list(_STEP_PATHS)} (or pass a fixture PATH)",
                          file=sys.stderr)
                    return 2
                paths = (args.comms,)
            surfaces = step_comms_surfaces(paths=paths, device=args.device)
            tables.append(render_comms_table(surfaces))
            reports.append(analyze_step_comms(paths=paths,
                                              _surfaces=surfaces))
    elif args.hbm is not None:
        from .hbm import analyze_hbm_plan, hbm_fixture_reports, smoke_plan

        if args.hbm and os.path.exists(args.hbm):
            reports.extend(hbm_fixture_reports(args.hbm))
        else:
            try:
                plan = smoke_plan(config_name=args.hbm or None,
                                  device=args.device)
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 2
            tables.append(plan.render_table())
            reports.append(analyze_hbm_plan(plan))
    elif args.surface is not None:
        from .compilesurface import (analyze_compile_surface,
                                     surface_fixture_reports)

        if args.surface:
            reports.extend(surface_fixture_reports(args.surface))
        else:
            reports.append(analyze_compile_surface())
    elif args.threads is not None:
        reports.append(_thread_report(args.threads or None))
    else:
        from .zoo import ZOO_PROGRAMS, zoo_reports

        include = None
        if args.programs:
            include = [p.strip() for p in args.programs.split(",")
                       if p.strip()]
            unknown = [p for p in include if p not in ZOO_PROGRAMS]
            if unknown:
                print(f"unknown program(s) {unknown}; available: "
                      f"{sorted(ZOO_PROGRAMS)}", file=sys.stderr)
                return 2
        reports.extend(zoo_reports(include=include, device=args.device))
        if include is None:     # the full self-check: the host runtime too
            reports.append(_thread_report())
            # ... and the suppressions themselves: a builtin entry that
            # matched nothing across the whole run is a stale WARN
            from .comms import BUILTIN_COMMS_ALLOWLIST
            from .compilesurface import BUILTIN_SURFACE_ALLOWLIST
            from .core import Report
            from .findings import BUILTIN_ALLOWLIST, stale_allowlist_findings
            from .hbm import BUILTIN_HBM_ALLOWLIST
            from .threads import BUILTIN_THREAD_ALLOWLIST

            stale = stale_allowlist_findings([
                ("graph", BUILTIN_ALLOWLIST),
                ("thread", BUILTIN_THREAD_ALLOWLIST),
                ("surface", BUILTIN_SURFACE_ALLOWLIST),
                ("hbm", BUILTIN_HBM_ALLOWLIST),
                ("comms", BUILTIN_COMMS_ALLOWLIST),
            ])
            reports.append(Report("allowlist.audit", stale, [],
                                  ("allowlist-stale",)))

    high_total = sum(len(r.high()) for r in reports)
    if args.json:
        print(json.dumps({
            "programs": [r.to_dict() for r in reports],
            "high_total": high_total,
            "status": "ok" if high_total == 0 else "lint-high",
        }))
    else:
        for t in tables:
            print(t)
        for r in reports:
            print(r.render())
        print(f"-- {len(reports)} program(s), {high_total} high-severity "
              f"finding(s) -> {'CLEAN' if high_total == 0 else 'FAIL'}")
    return 0 if high_total == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
