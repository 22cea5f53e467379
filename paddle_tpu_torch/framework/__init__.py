"""Device and RNG plumbing shared by the port's modules."""
from .device import resolve_device
from .random import (
    default_generator,
    get_rng_state,
    make_generator,
    seed,
    set_rng_state,
)

__all__ = ["resolve_device", "make_generator", "seed", "default_generator",
           "get_rng_state", "set_rng_state"]
