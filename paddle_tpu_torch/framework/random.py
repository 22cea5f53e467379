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

import os

import torch

__all__ = ["make_generator", "seed", "default_generator", "get_rng_state",
           "set_rng_state"]

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
