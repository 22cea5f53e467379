"""The port's ``distributed.auto_tuner`` against ``tests/
test_auto_tuner.py``'s bodies. The port's defaults are the NVIDIA H100
80GB HBM3 datasheet's (989e12 FLOP/s dense bf16, 450e9 B/s NVLink, 80e9
B); the JAX bodies' rankings and prunes are the TPU figures', so the
bodies pass JAX's (197e12, 4.5e10, 16e9) explicitly and are held to the
JAX package's answers on the same inputs. The live-trial body runs its
trials through the port's ``DistModel`` on eight gloo ranks (one spawn in
a module fixture): each candidate (dp, mp) builds a mesh, parallelizes a
two-layer MLP by its plan and takes three steps.
"""
import numpy as np
import pytest

from paddle_tpu.distributed import auto_tuner as J
from paddle_tpu_torch.distributed import auto_tuner as T

import dist_ranks

TPU = dict(chip_flops=197e12, ici_bw=4.5e10)


def _spec(mod, **kw):
    return mod.ModelSpec(**kw)


def test_defaults_are_the_card_datasheet():
    assert (T.CARD_FLOPS, T.CARD_LINK_BYTES_S, T.CARD_MEMORY) == (
        989e12, 450e9, 80e9)


def test_candidates_cover_factorizations():
    for kw in (dict(use_sharding=False), dict(), dict(max_mp=2, max_pp=2)):
        assert T.generate_candidates(8, **kw) == J.generate_candidates(
            8, **kw)
    combos = {(c["dp_degree"], c["mp_degree"], c["pp_degree"])
              for c in T.generate_candidates(8, use_sharding=False)}
    assert (8, 1, 1) in combos and (1, 8, 1) in combos and (2, 2, 2) in combos
    assert all(a * b * c == 8 for a, b, c in combos)


def test_memory_model_matches_jax_and_is_monotone():
    kw = dict(num_params=1.3e9, num_layers=24, hidden=2048, seq_len=1024,
              global_batch=32)
    base = {"dp_degree": 8, "mp_degree": 1, "pp_degree": 1,
            "micro_batches": 1}
    mems = [T.estimate_memory_bytes({**base, "sharding_stage": s},
                                    _spec(T, **kw)) for s in range(4)]
    want = [J.estimate_memory_bytes({**base, "sharding_stage": s},
                                    _spec(J, **kw)) for s in range(4)]
    np.testing.assert_allclose(mems, want, rtol=1e-12)
    assert mems[0] > mems[1] > mems[2] > mems[3]


def test_cost_model_matches_jax_with_its_figures():
    kw = dict(num_params=3.5e8, num_layers=24, hidden=1024, seq_len=1024,
              global_batch=64)
    for c in T.generate_candidates(8):
        np.testing.assert_allclose(
            T.estimate_step_time(c, _spec(T, **kw), **TPU),
            J.estimate_step_time(c, _spec(J, **kw)), rtol=1e-12)
    dp = {"dp_degree": 8, "mp_degree": 1, "pp_degree": 1,
          "sharding_stage": 0, "micro_batches": 1}
    mp = dict(dp, dp_degree=1, mp_degree=8)
    assert T.estimate_step_time(dp, _spec(T, **kw), **TPU) < \
        T.estimate_step_time(mp, _spec(T, **kw), **TPU)


def test_tuner_prunes_oom_and_orders_by_estimate():
    kw = dict(num_params=1.3e9, num_layers=24, hidden=2048, seq_len=1024,
              global_batch=16)
    tuner = T.AutoTuner({"world_size": 8, "model_spec": _spec(T, **kw),
                         "hbm_bytes": 16e9, **TPU})
    jtuner = J.AutoTuner({"world_size": 8, "model_spec": _spec(J, **kw),
                          "hbm_bytes": 16e9})
    assert tuner.candidates == jtuner.candidates
    combos = {(c["dp_degree"], c["mp_degree"], c["pp_degree"],
               c["sharding_stage"]) for c in tuner.candidates}
    assert (8, 1, 1, 0) not in combos
    # at the card's 80 GB the unsharded dp-only 1.3B fits
    card = T.AutoTuner({"world_size": 8, "model_spec": _spec(T, **kw)})
    assert (8, 1, 1, 0) in {(c["dp_degree"], c["mp_degree"], c["pp_degree"],
                             c["sharding_stage"]) for c in card.candidates}


def test_tune_runs_trials_and_picks_best():
    kw = dict(num_params=3.5e8, num_layers=24, hidden=1024, seq_len=1024,
              global_batch=64)
    results = {}
    for mod, extra in ((T, TPU), (J, {})):
        tuner = mod.AutoTuner({"world_size": 8, "model_spec": _spec(mod, **kw),
                               "task_limit": 6, **extra})
        seen = []

        def trial(cfg):
            seen.append(cfg)
            if cfg["mp_degree"] >= 4:
                raise RuntimeError("simulated bad config")
            return 100.0 + cfg["dp_degree"]

        best = tuner.tune(trial)
        results[mod.__name__] = (best, seen, tuner.history)
    (best, seen, hist), (jbest, jseen, jhist) = results.values()
    assert seen == jseen and best == jbest
    assert len(seen) == 6
    assert best["metric"] == max(100.0 + c["dp_degree"] for c in seen
                                 if c["mp_degree"] < 4)
    assert all("simulated" in h["error"] for h in hist if h["error"])


@pytest.fixture(scope="module")
def live():
    return dist_ranks.run_ranks(["dist_auto_bodies:body_tuner_trials"], 8,
                                {})


def test_tuner_with_real_distmodel_trials(live):
    recs = [r["dist_auto_bodies:body_tuner_trials"] for r in live]
    best = recs[0]["best"]
    assert best is not None and best["metric"] > 0
    assert recs[0]["tried"] == 3
    # every rank ran the same trials and agrees on the winner
    assert all(r["best_cfg"] == recs[0]["best_cfg"] for r in recs)
