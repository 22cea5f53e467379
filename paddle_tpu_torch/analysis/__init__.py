"""paddle_tpu_torch.analysis — the lints over traced programs and over the
port's own threading, the port of ``paddle_tpu/analysis``.

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
* the thread lint (``threads``): an AST pass over the port's source —
  lock-order-cycle, unguarded-write, blocking-under-lock, raw-clock,
  non-daemon-thread — and its runtime twin, the lock witness
  (``lockwitness``): the runtime modules make their locks through
  ``make_lock`` / ``make_rlock``, plain locks unless a ``LockWitness`` is
  active;
* the comms lint (``comms``): the tensor-parallel step programs traced at
  tp = 2 over a fake process group, their c10d collectives inventoried
  with bytes on wire, the layouts held to ``SpecLayout`` —
  implicit-reshard, layout-contract-drift, comms-over-budget,
  replicated-large-buffer, dead-mesh-axis; ``DeploymentPlan.comms``;
* the zoo (``zoo``) and the CLI (``python -m paddle_tpu_torch.analysis``,
  whose exit status is the gate).

``StepMonitor(lint=True)`` lints its step once at the first launch.
"""
from .comms import (  # noqa: F401
    BUILTIN_COMMS_ALLOWLIST,
    COMMS_RULES,
    CollectiveOp,
    CommsBudget,
    CommsEstimate,
    analyze_comms_surfaces,
    analyze_step_comms,
    bytes_on_wire,
    collective_inventory,
    comms_fixture_reports,
    render_comms_table,
    sampled_logits_gather_surface,
    smoke_comms_budget,
    step_comms_surfaces,
    tp_world,
)
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
from .lockwitness import (  # noqa: F401
    LockWitness,
    make_lock,
    make_rlock,
)
from .rules import RULES  # noqa: F401
from .threads import (  # noqa: F401
    BUILTIN_THREAD_ALLOWLIST,
    RUNTIME_MODULES,
    THREAD_RULES,
    analyze_threads,
    lock_order_graph,
    record_findings,
)
