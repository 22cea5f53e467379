"""The golden op tables (``tests/test_op_golden.py``: UNARY, BINARY, LOGIC,
REDUCTION, CREATION, SEARCH; ``tests/test_op_golden2.py``: MANIP, LINALG,
and the ``nn.functional`` tables ACTIVATIONS, LOSSES, NN_SHAPE) run on the
PyTorch port's op layer and nn functionals, on the CPU.

The tables are imported by name and kept in one place: an entry's ``fn``
is either an op of the JAX package, mapped to the port's op of the same
name, or a lambda over the module globals ``P`` / ``paddle`` / ``F``,
rebuilt here over the same code with those globals bound to the port.
Each case draws its inputs once (see below) and feeds the same arrays to
numpy, JAX and the port. Three checks, at the
table's own tolerances (``rtol`` / ``atol``, ``grad_rtol`` / ``grad_atol``),
through the harness ``chip_smoke.py`` uses on the card
(``paddle_tpu_torch.testing``):

* eager: the port's output against the numpy reference;
* JAX: the port's output against the JAX package's, values and dtypes;
* grad: torch autograd through the port against central differences of
  the numpy reference in float64, as ``op_test._check_grad`` does for the
  JAX tape (the same projection weights and sampled coordinates).

The tables' jit mode has its card counterpart in ``chip_smoke.py``'s core
phase (each case captured in a CUDA graph and replayed).

The cases' inputs come from the harness's reading of the same tables
(``testing.load_tables``), drawn from a generator of this module's own,
seeded as op_test's is (2024) and drawn in the tables' order, as the card
harness draws them; ``op_test``'s generator, which the JAX golden tests
share within a worker process, is left alone. Some cases depend on the
draw: ``hardsigmoid``'s slope 0.1666667 (paddle's, in both packages)
against the reference's x / 6 is off by up to 2.7e-7, above the table's
rtol 1e-6 wherever an output lies in (0, 0.1) (ROADMAP C, open).
"""
import os
import types

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as port
from paddle_tpu_torch import testing as harness
from paddle_tpu_torch.nn import functional as port_F
from port_bodies import dname, on_cpu  # noqa: F401
from test_op_golden import BINARY, CREATION, LOGIC, REDUCTION, SEARCH, UNARY
from test_op_golden2 import ACTIVATIONS, LINALG, LOSSES, MANIP, NN_SHAPE

TABLES = {"UNARY": UNARY, "BINARY": BINARY, "LOGIC": LOGIC,
          "REDUCTION": REDUCTION, "CREATION": CREATION, "SEARCH": SEARCH,
          "MANIP": MANIP, "LINALG": LINALG, "ACTIVATIONS": ACTIVATIONS,
          "LOSSES": LOSSES, "NN_SHAPE": NN_SHAPE}
SPECS = [s for t in TABLES.values() for s in t if s is not None]

# the JAX package's op objects, by identity -> (port namespace, name)
_JAX_OPS = {}
for _ns, _pns in ((paddle_tpu, port), (paddle_tpu.linalg, port.linalg),
                  (paddle_tpu.nn.functional, port_F)):
    for _n, _obj in vars(_ns).items():
        if callable(_obj) and not _n.startswith("_"):
            _JAX_OPS.setdefault(id(_obj), (_pns, _n))


# each case's inputs, by id, drawn from this module's generator
INPUTS = {c["id"]: c["inputs"]
          for cases in harness.load_tables(
              os.path.dirname(__file__), port, port_F,
              gen=np.random.default_rng(2024)).values()
          for c in cases}


def port_fn(fn):
    """The port's counterpart of a table entry's ``fn``."""
    if id(fn) in _JAX_OPS:
        ns, name = _JAX_OPS[id(fn)]
        return getattr(ns, name)
    g = {**fn.__globals__, "P": port, "paddle": port, "F": port_F}
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


@pytest.mark.parametrize("spec", SPECS, ids=[s["id"] for s in SPECS])
def test_golden_port(on_cpu, spec):
    opts = dict(spec["opts"])
    rtol, atol = opts.get("rtol", 1e-6), opts.get("atol", 1e-8)
    kwargs = opts.get("kwargs") or {}
    inputs = INPUTS[spec["id"]]()
    fn = port_fn(spec["fn"])
    want = spec["ref"](*[np.copy(a) for a in inputs])
    got = fn(*[port.to_tensor(np.copy(a)) for a in inputs], **kwargs)
    harness.compare(got, want, rtol, atol, f"{spec['id']}:eager")

    jax_out = spec["fn"](*[paddle_tpu.to_tensor(np.copy(a)) for a in inputs],
                         **kwargs)
    harness.compare(got, jax_out, rtol, atol, f"{spec['id']}:jax")
    assert ([dname(t) for t in harness.leaves(got)]
            == [dname(t) for t in harness.leaves(jax_out)]), spec["id"]

    if opts.get("check_grad", True):
        idx = opts.get("grad_indices")
        if idx is None:
            idx = [i for i, a in enumerate(inputs)
                   if np.issubdtype(np.asarray(a).dtype, np.floating)]
        if idx:
            harness.check_grad(
                spec["id"], fn, spec["ref"], inputs, kwargs, idx,
                opts.get("grad_rtol", 5e-4), opts.get("grad_atol", 1e-6),
                opts.get("grad_eps", 1e-5), opts.get("grad_samples", 6),
                port.to_tensor)


def test_tables_are_the_jax_packages_own(on_cpu):
    """240 cases (the 196 op cases and the 44 nn.functional ones), the
    objects the JAX golden tests run; the harness's
    loader (what ``chip_smoke.py`` runs on the card, without JAX) reads the
    same cases from the same files, ops bound to the port's."""
    assert len(SPECS) == 240 and len(INPUTS) == 240
    import test_op_golden
    import test_op_golden2

    assert test_op_golden.UNARY is UNARY and test_op_golden2.LINALG is LINALG
    loaded = harness.load_tables(os.path.dirname(__file__), port, port_F)
    assert {k: [c["id"] for c in v] for k, v in loaded.items()} == {
        k: [c["id"] for c in v if c is not None] for k, v in TABLES.items()}
    for name, cases in loaded.items():
        for case, spec in zip(cases, [c for c in TABLES[name]
                                      if c is not None]):
            assert case["opts"] == spec["opts"], case["id"]
            f = port_fn(spec["fn"])
            if isinstance(f, types.FunctionType) and f.__module__ and \
                    f.__module__.startswith("paddle_tpu_torch"):
                assert case["fn"] is f, case["id"]


def test_port_tensors_land_on_the_place_asked_for(on_cpu):
    assert port.get_device() == "cpu"
    assert port.zeros([2]).place.is_cpu_place()
    assert port.to_tensor([1.0]).place == port.CPUPlace()
