"""paddle_tpu_torch.analysis — the lints over traced programs, the port of
``paddle_tpu/analysis`` (part 1 of ROADMAP item 6).

The port's step programs are captured into CUDA graphs, which hold no
program text; the program the lints read is an FX graph traced over fake
tensors (``core.trace``), in which every aten operator and every port
kernel (a ``torch.library`` operator with a fake) is a node and in-place
writes stay visible. Tracing launches nothing and changes no state.

    from paddle_tpu_torch import analysis
    report = analysis.analyze(fn, *example_args)
    report = analysis.analyze_train_step(step, x, labels=y)
    for f in report.high():
        print(f.render())

Ported legs:

* the graph lint (``core``, ``rules``, ``findings``): donation-miss,
  dtype-upcast, host-sync, constant-bloat, recompile-hazard,
  collective-axis;
* the compile surface (``compilesurface``): the decode paths' cache-key
  schemas, ``ServingConfig`` / ``ProgramManifest``, manifest-incomplete,
  unbounded-key, dead-bucket; ``inference/warmup.py``'s ``program_keys``
  is its derivation;
* the HBM residency plan (``hbm``): the storage-liveness estimator, the
  measured body peak on the card, ``DeploymentPlan``, hbm-over-budget,
  estimate-drift, oversized-temp, pool-misfit, and ``plan_kv_pool``, which
  the continuous scheduler's ``hbm_budget=`` sizes its pool with;
* the zoo (``zoo``) and the CLI (``python -m paddle_tpu_torch.analysis``,
  whose exit status is the gate).

Not ported yet (ROADMAP A6, part 2): the thread lint and the lock witness
(JAX ``threads.py``, ``lockwitness.py``), the comms lint (``comms.py``),
the zoo's ``*_tp`` and ``comms_surface`` entries and the CLI's
``--threads`` / ``--comms``, which raise ``NotImplementedError``.
``StepMonitor(lint=True)`` lints its step once at the first launch.
"""
from .compilesurface import (  # noqa: F401
    BUILTIN_SURFACE_ALLOWLIST,
    SURFACE_RULES,
    CompileSurfaceError,
    ProgramManifest,
    ServingConfig,
    analyze_compile_surface,
    default_manifest,
    default_serving_configs,
    extract_key_schemas,
    surface_fixture_reports,
    zoo_cross_check,
)
from .core import (  # noqa: F401
    Program,
    Report,
    Thresholds,
    analyze,
    analyze_exported,
    analyze_graph,
    analyze_jaxpr,
    analyze_lowered,
    analyze_runner,
    analyze_train_step,
    trace,
    trace_runner,
    trace_train_step,
)
from .findings import (  # noqa: F401
    BUILTIN_ALLOWLIST,
    HIGH,
    INFO,
    WARN,
    Allowlist,
    AllowlistEntry,
    Finding,
    stale_allowlist_findings,
)
from .hbm import (  # noqa: F401
    BUILTIN_HBM_ALLOWLIST,
    HBM_RULES,
    DeploymentPlan,
    PeakEstimate,
    ProgramEstimate,
    analyze_hbm_plan,
    analyze_hbm_residency,
    estimate_memory_stats,
    estimate_peak,
    hbm_fixture_reports,
    measure_body_peak,
    params_bytes_of,
    plan_kv_pool,
)
from .rules import RULES  # noqa: F401

PART2 = ("not ported yet: the thread lint, the lock witness and the comms "
         "lint are ROADMAP A6, part 2")


def _part2(name):
    def missing(*args, **kwargs):
        raise NotImplementedError(f"analysis.{name}: {PART2}")
    missing.__name__ = name
    return missing


analyze_threads = _part2("analyze_threads")
analyze_step_comms = _part2("analyze_step_comms")
LockWitness = _part2("LockWitness")
