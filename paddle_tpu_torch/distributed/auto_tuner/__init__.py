"""The hybrid-parallel auto-tuner — the counterpart of
``paddle_tpu/distributed/auto_tuner/__init__.py`` (Paddle
``auto_tuner/tuner.py``: ``AutoTuner`` with candidate generation and
``search_once`` over a history; ``prune.py``).

The candidates are the factorisations of the card count into (dp, mp, pp)
with a ZeRO stage and a micro-batch count; the memory model prunes those
that cannot fit a card, and the cost model (compute at an assumed MFU, the
mp all-reduces, the pipeline bubble, the dp gradient all-reduce) orders
the rest; ``tune(trial_fn)`` replaces both by real trials. The formulas
are JAX's. The defaults are this card's, from the NVIDIA H100 80GB HBM3
datasheet: 989e12 FLOP/s dense bf16 (``CARD_FLOPS``), 450e9 B/s of NVLink
each way (``CARD_LINK_BYTES_S``) and 80e9 B of memory (``CARD_MEMORY``).
JAX's defaults (197e12, 4.5e10, 16e9) are a TPU's; pass them to
reproduce its rankings.
"""
from __future__ import annotations

import itertools
import math

# NVIDIA H100 80GB HBM3 datasheet
CARD_FLOPS = 989e12           # dense bf16 FLOP/s
CARD_LINK_BYTES_S = 450e9     # NVLink, each way
CARD_MEMORY = 80e9            # bytes


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def generate_candidates(world_size, max_mp=None, max_pp=None,
                        use_sharding=True, micro_batches=(1, 2, 4, 8)):
    """All (dp, mp, pp, sharding_stage, micro_batch) with dp*mp*pp == world."""
    out = []
    for mp in _divisors(world_size):
        if max_mp and mp > max_mp:
            continue
        for pp in _divisors(world_size // mp):
            if max_pp and pp > max_pp:
                continue
            dp = world_size // (mp * pp)
            stages = [0, 1, 2, 3] if (use_sharding and dp > 1) else [0]
            for sh in stages:
                for mbs in micro_batches if pp > 1 else (1,):
                    out.append({
                        "dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_stage": sh, "micro_batches": mbs,
                    })
    return out


class ModelSpec:
    """Minimal transformer shape description for the analytic models."""

    def __init__(self, num_params, num_layers, hidden, seq_len, global_batch,
                 vocab=50304, bytes_per_param=2):
        self.num_params = num_params
        self.num_layers = num_layers
        self.hidden = hidden
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.vocab = vocab
        self.bytes_per_param = bytes_per_param


def estimate_memory_bytes(cfg, spec: ModelSpec, optimizer_factor=6.0):
    """Bytes a card holds: parameters, gradients and optimizer states
    under (mp, pp, sharding), and activations under (dp, pp,
    micro_batches). Coarse but monotone in the knobs: it prunes the
    configurations that cannot fit (Paddle's prune.py)."""
    mp, pp, dp = cfg["mp_degree"], cfg["pp_degree"], cfg["dp_degree"]
    sh = cfg["sharding_stage"]
    params_per_chip = spec.num_params / (mp * pp)
    # bytes per parameter: the weight, an f32 gradient, and AdamW's
    # moments and master copy (12), each over the ranks that shard it
    weight_div = dp if sh >= 3 else 1
    opt_div = dp if sh >= 1 else 1
    grad_div = dp if sh >= 2 else 1
    mem = params_per_chip * (
        spec.bytes_per_param / weight_div + 4 / grad_div + 12 / opt_div)
    # activations: a micro-batch of the dp slice of the global batch
    mb = spec.global_batch / dp / max(cfg["micro_batches"], 1)
    act = (mb * spec.seq_len * spec.hidden * spec.num_layers / pp
           / mp) * 2 * 16
    return mem + act


def estimate_step_time(cfg, spec: ModelSpec, chip_flops=CARD_FLOPS,
                       ici_bw=CARD_LINK_BYTES_S, mfu=0.4):
    """Roofline cost: compute + mp all-reduce traffic + pp bubble + dp grad
    all-reduce, in seconds (``ici_bw``: the link's bytes a second). A
    ranking signal, not a simulator."""
    mp, pp, dp = cfg["mp_degree"], cfg["pp_degree"], cfg["dp_degree"]
    m = max(cfg["micro_batches"], 1)
    flops = 6.0 * spec.num_params * spec.global_batch * spec.seq_len
    compute = flops / (dp * mp * pp) / (chip_flops * mfu)
    # mp: 4 all-reduces per layer of [b, s, h] activations (fwd+bwd)
    if mp > 1:
        tokens = spec.global_batch / dp * spec.seq_len
        mp_bytes = 4 * spec.num_layers / pp * tokens * spec.hidden * 2
        mp_t = mp_bytes * 2 * (mp - 1) / mp / ici_bw
    else:
        mp_t = 0.0
    # pp bubble: (pp-1)/m of the compute
    bubble = compute * (pp - 1) / m if pp > 1 else 0.0
    # dp: grad all-reduce (or reduce-scatter+gather, same bytes)
    if dp > 1:
        dp_bytes = spec.num_params / (mp * pp) * 4
        dp_t = dp_bytes * 2 * (dp - 1) / dp / ici_bw
    else:
        dp_t = 0.0
    return compute + mp_t + bubble + dp_t


class AutoTuner:
    """Paddle ``tuner.py:21``. ``search_once`` yields the next unexplored
    candidate (cheapest estimate first); ``add_cfg`` records a finished
    trial; ``best`` returns the winner by the measured metric (higher is
    better). ``tuner_cfg`` keys: ``world_size``, ``model_spec``,
    ``max_mp``, ``max_pp``, ``use_sharding``, ``task_limit``,
    ``hbm_bytes`` (default ``CARD_MEMORY``), and ``chip_flops`` /
    ``ici_bw`` for the cost model (default the card's)."""

    def __init__(self, tuner_cfg):
        self.cfg = dict(tuner_cfg)
        world = self.cfg["world_size"]
        spec = self.cfg.get("model_spec")
        self.spec = spec
        cands = generate_candidates(
            world,
            max_mp=self.cfg.get("max_mp"),
            max_pp=self.cfg.get("max_pp"),
            use_sharding=self.cfg.get("use_sharding", True),
        )
        hbm = self.cfg.get("hbm_bytes", CARD_MEMORY)
        cost_kw = {k: self.cfg[k] for k in ("chip_flops", "ici_bw")
                   if k in self.cfg}
        if spec is not None:
            cands = [c for c in cands
                     if estimate_memory_bytes(c, spec) <= hbm * 0.9]
            cands.sort(key=lambda c: estimate_step_time(c, spec, **cost_kw))
        self.candidates = cands
        self.task_limit = self.cfg.get("task_limit", len(cands))
        self.cur_task_id = 0
        self.history = []

    def search_once(self):
        if self.cur_task_id >= min(self.task_limit, len(self.candidates)):
            return None
        cfg = self.candidates[self.cur_task_id]
        self.cur_task_id += 1
        return dict(cfg)

    def add_cfg(self, cfg, metric=None, error=None):
        self.history.append({"cfg": dict(cfg), "metric": metric,
                             "error": error})

    def best(self):
        ok = [h for h in self.history
              if h["error"] is None and h["metric"] is not None]
        if not ok:
            return None
        # metric convention: higher is better (throughput)
        return max(ok, key=lambda h: h["metric"])

    # ---------------------------------------------------------------- driver
    def tune(self, trial_fn):
        """Run trial_fn(cfg) -> metric (higher=better; raise to mark failure)
        over the candidate stream; returns the best history entry."""
        while (cfg := self.search_once()) is not None:
            try:
                metric = trial_fn(cfg)
                self.add_cfg(cfg, metric=metric)
            except Exception as e:  # pruned at runtime (OOM, invalid combo)
                self.add_cfg(cfg, error=repr(e)[:200])
        return self.best()
