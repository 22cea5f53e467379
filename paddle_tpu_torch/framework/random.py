"""Seeding through explicit ``torch.Generator`` objects, and the port's
default generator — the counterpart of ``paddle_tpu/framework/random.py``
(``seed``, ``default_generator``, ``next_key`` :77-90).

The JAX package threads ``jax.random`` keys; the port threads generators.
No code in the port touches torch's global RNG, so two models or two
schedulers in one process never perturb each other's draws. Random ops
(dropout) draw from the port's default generator of their tensor's device
(``default_generator(device)``: one per device, made on first use, seeded
by ``seed``), as JAX's draw ``next_key()`` from its default generator.
``seed`` reseeds the existing generators in place, so a CUDA graph that
registered one (``jit.TrainStep``) keeps it. The two frameworks give
different numbers from the same seed: cross-backend tests hold sampled
paths to distribution pins, never to bit identity.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["make_generator", "seed", "default_generator", "get_rng_state",
           "set_rng_state", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]

_GENERATORS: dict = {}      # torch.device -> the device's default generator
# the seed of generators made from now on (JAX's default generator starts
# from a random seed too)
_SEED = {"value": int.from_bytes(os.urandom(4), "little") >> 1}


def make_generator(seed, device="cpu") -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device="cuda") -> torch.Generator:
    """The port's default generator of ``device``, made on first use from the
    current seed."""
    dev = _key(device)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = _GENERATORS[dev] = make_generator(_SEED["value"], dev)
    return gen


def seed(s: int):
    """``paddle.seed``: every default generator, and those made later, start
    over from ``s``. Returns the CPU default generator."""
    _SEED["value"] = int(s)
    for gen in _GENERATORS.values():
        gen.manual_seed(int(s))
    return default_generator("cpu")


def get_rng_state(device="cuda") -> torch.Tensor:
    """The state of ``device``'s default generator (a CPU uint8 tensor)."""
    return default_generator(device).get_state()


def set_rng_state(state, device="cuda"):
    default_generator(device).set_state(torch.as_tensor(state,
                                                        dtype=torch.uint8))


class RNGStatesTracker:
    """Named random streams for tensor parallelism (JAX
    ``framework/random.py:98-140``, Paddle ``mpu/random.py``): each name is
    a ``torch.Generator`` of its own on the rank's device. "global_seed"
    is the same on every rank of the model-parallel group (dropout on
    replicated activations), "local_seed" differs per rank (dropout on
    sharded ones). Under ``rng_state(name)`` the stream stands in for the
    device's default generator, so the port's random ops draw from it."""

    def __init__(self):
        self._states: dict = {}

    def reset(self):
        self._states = {}

    def add(self, name, s, device=None):
        if name in self._states:
            raise ValueError(f"state {name!r} already exists")
        if device is None:
            from ..distributed import env

            device = env.device()
        self._states[name] = make_generator(s, device)

    def get_states_tracker(self):
        return {k: (g.device, g.get_state()) for k, g in self._states.items()}

    def set_states_tracker(self, states):
        self._states = {}
        for k, (dev, st) in states.items():
            gen = torch.Generator(device=dev)
            gen.set_state(st)
            self._states[k] = gen

    @contextlib.contextmanager
    def rng_state(self, name="global_seed"):
        if name not in self._states:
            raise ValueError(f"state {name!r} not added yet")
        gen = self._states[name]
        dev = _key(gen.device)
        prev = _GENERATORS.get(dev)
        _GENERATORS[dev] = gen
        try:
            yield gen
        finally:
            if prev is None:
                _GENERATORS.pop(dev, None)
            else:
                _GENERATORS[dev] = prev


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_random_seed(seed_=None, tp_rank=None):
    """Set up the "global_seed" and "local_seed" streams (JAX :143-152):
    global = 100003 + seed on every rank, local = seed + 1024 + 100 *
    tp_rank, and reseed the default generators with the global seed.
    ``tp_rank`` defaults to this rank's place in the model-parallel
    group."""
    if seed_ is None:
        seed_ = 2048
    if tp_rank is None:
        from ..distributed.fleet.base import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        tp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    global_seed = 100003 + int(seed_)
    local_seed = int(seed_) + 1024 + int(tp_rank) * 100
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("global_seed", global_seed)
    _RNG_TRACKER.add("local_seed", local_seed)
    seed(global_seed)
