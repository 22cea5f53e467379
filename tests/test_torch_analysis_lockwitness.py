"""The port's runtime lock witness (``paddle_tpu_torch/analysis/
lockwitness.py``) held to JAX's (``paddle_tpu/analysis/lockwitness.py``).

Every scripted acquisition sequence runs once through each package's
``make_lock`` / ``make_rlock`` under that package's active witness, from
the same lines of this file, so the two summaries (acquisitions, edges
with their sites, inversions with both sites, race candidates), the edge
tables and ``check_static``'s cycles must be equal. Then the port's own
runtime locks: created through ``make_lock`` under JAX's names, plain when
no witness is active, and a pool + prefix-cache sequence records the same
edge under both packages.
"""
import os
import re
import threading

import numpy as np
import pytest

import paddle_tpu.analysis.lockwitness as JW
import paddle_tpu_torch.analysis.lockwitness as TW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(mod, script):
    w = mod.LockWitness()
    mod.activate(w)
    try:
        extra = script(mod, w)
    finally:
        mod.deactivate()
    return w, extra


# ------------------------------------------------------ scripted sequences
def nested(mod, w):
    a, b = mod.make_lock("A"), mod.make_lock("B")
    with a:
        with b:
            pass


def reversed_nesting(mod, w):
    a, b = mod.make_lock("A"), mod.make_lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def rlock_reentry(mod, w):
    r = mod.make_rlock("R")
    with r:
        with r:
            pass


def same_name_instances(mod, w):
    l1 = mod.make_lock("kv_cache.PagedKVCache._lock")
    l2 = mod.make_lock("kv_cache.PagedKVCache._lock")
    with l1:
        with l2:
            pass


def cross_thread_inversion(mod, w):
    a, b = mod.make_lock("A"), mod.make_lock("B")
    with a:
        with b:
            pass

    def other():
        with b:
            with a:
                pass

    t = threading.Thread(target=other, daemon=True)
    t.start()
    t.join(5)


def explicit_acquire_release(mod, w):
    a, b = mod.make_lock("A"), mod.make_lock("B")
    assert a.acquire()
    assert b.acquire(blocking=False)
    b.release()
    a.release()
    with b:
        pass


def field_lockset_race(mod, w):
    lk = mod.make_lock("L")
    with lk:
        w.note_field("Pool.pages")
    first = w.field_lockset("Pool.pages")
    done = threading.Event()

    def unlocked_access():
        w.note_field("Pool.pages")
        done.set()

    threading.Thread(target=unlocked_access, daemon=True).start()
    assert done.wait(5)
    return first, w.field_lockset("Pool.pages")


def three_locks_many_threads(mod, w):
    """Eight threads taking A -> B -> C in one order, re-entering an RLock
    around the middle: edges, no inversion."""
    a, b, c = (mod.make_lock("A"), mod.make_rlock("B"),
               mod.make_lock("C"))

    def worker():
        for _ in range(20):
            with a:
                with b:
                    with b:
                        with c:
                            pass

    ts = [threading.Thread(target=worker, daemon=True) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)


def static_cycle(mod, w):
    a, b = mod.make_lock("A"), mod.make_lock("B")
    with a:
        with b:
            pass
    return (w.check_static([]), w.check_static([("B", "A")]),
            w.check_static({("C", "D"): "x", ("D", "C"): "y"}))


SCRIPTS = [nested, reversed_nesting, rlock_reentry, same_name_instances,
           cross_thread_inversion, explicit_acquire_release,
           field_lockset_race, three_locks_many_threads, static_cycle]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__)
def test_scripted_sequence_matches_jax(script):
    jw, jextra = _run(JW, script)
    tw, textra = _run(TW, script)
    assert tw.summary() == jw.summary()
    assert tw.edges == jw.edges
    assert tw.inversions == jw.inversions
    assert tw.acquisitions == jw.acquisitions
    assert textra == jextra
    assert tw.check_static([]) == jw.check_static([])
    # the sites name this file, on the same lines for both packages
    for site in tw.edges.values():
        assert site.startswith(__file__) or "test_torch_analysis_lock" \
            in site


def test_expected_outcomes_of_the_scripts():
    """The scripts exercise what JAX's rules say: an inversion seen live,
    none for a re-entry or a same-named pair, a race candidate for an
    unlocked second thread, and the cycle check_static names."""
    assert len(_run(TW, reversed_nesting)[0].inversions) == 1
    assert len(_run(TW, cross_thread_inversion)[0].inversions) == 1
    w, _ = _run(TW, rlock_reentry)
    assert (w.acquisitions, w.edges) == (1, {})
    assert _run(TW, same_name_instances)[0].edges == {}
    w, (first, after) = _run(TW, field_lockset_race)
    assert first == frozenset({"L"}) and after == frozenset()
    assert w.race_candidates()[0]["field"] == "Pool.pages"
    w, _ = _run(TW, three_locks_many_threads)
    assert set(w.edges) == {("A", "B"), ("A", "C"), ("B", "C")}
    assert w.inversions == []
    _w, (none, ab, cd) = _run(TW, static_cycle)
    assert none == [] and [set(c[:-1]) for c in ab] == [{"A", "B"}]
    assert [set(c[:-1]) for c in cd] == [{"C", "D"}]


def test_find_cycles_matches_jax():
    for adj in ({"a": {"b"}, "b": {"c"}}, {"a": {"b"}, "b": {"a"}},
                {"a": {"b"}, "b": {"a"}, "x": {"y"}, "y": {"x"}},
                {"a": {"b"}, "b": {"c"}, "c": {"a"}, "d": {"a"}}):
        assert TW._find_cycles(adj) == JW._find_cycles(adj)


def test_make_lock_is_plain_without_a_witness():
    assert TW.active_witness() is None
    assert type(TW.make_lock("x")) is type(threading.Lock())
    assert type(TW.make_rlock("x")) is type(threading.RLock())


def test_locks_made_under_a_witness_keep_reporting():
    w = TW.LockWitness()
    TW.activate(w)
    try:
        lk = TW.make_lock("A")
    finally:
        TW.deactivate()
    with lk:
        pass
    assert w.acquisitions == 1
    assert type(TW.make_lock("B")) is type(threading.Lock())


def test_module_lock_reports_to_the_witness_active_at_acquisition():
    """A lock a module makes at import (a port-only form): plain behaviour
    with no witness, and each acquisition reported to the witness active
    then — nested under it, a runner's lock gives the edge."""
    m = TW.make_module_lock("graphs._CAPTURE_LOCK")
    r = TW.make_module_rlock("generation._SWAP_LOCK")
    with m, r, r:
        pass
    w = TW.LockWitness()
    TW.activate(w)
    try:
        run = TW.make_lock("graphs.StepRunner.lock")
        with run:
            with m:
                with r:
                    with r:
                        pass
    finally:
        TW.deactivate()
    with run, m:            # after deactivate: only run still reports
        pass
    assert set(w.edges) == {
        ("graphs.StepRunner.lock", "graphs._CAPTURE_LOCK"),
        ("graphs.StepRunner.lock", "generation._SWAP_LOCK"),
        ("graphs._CAPTURE_LOCK", "generation._SWAP_LOCK")}
    assert w.acquisitions == 4 and w.inversions == []
    from paddle_tpu_torch.jit import graphs
    from paddle_tpu_torch.models import generation

    assert graphs._CAPTURE_LOCK.name == "graphs._CAPTURE_LOCK"
    assert generation._SWAP_LOCK.name == "generation._SWAP_LOCK"


# --------------------------------------------------- the port's own locks
_NAME_RE = re.compile(r'make_(?:module_)?r?lock\(\s*"([^"]+)"')


def _lock_names(package):
    names = {}
    root = os.path.join(REPO, package)
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build", "csrc",
                                    "analysis")]
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as fh:
                    for name in _NAME_RE.findall(fh.read()):
                        names[name] = os.path.relpath(
                            os.path.join(dirpath, fn), root)
    return names


def test_port_runtime_locks_carry_jax_names():
    """Every lock JAX makes through make_lock is made under the same name
    by the port's counterpart module; the port-only locks (the capture
    lock, the runner lock, the swap lock, the lockstep leader's, the
    speculative spare pool's, the profile and answers locks) follow the
    same module.Class.attr scheme."""
    jax_names = _lock_names("paddle_tpu")
    port = _lock_names("paddle_tpu_torch")
    for name, path in jax_names.items():
        assert port.get(name) == path, (name, path, port.get(name))
    port_only = set(port) - set(jax_names)
    assert port_only == {
        "graphs._CAPTURE_LOCK", "graphs.StepRunner.lock",
        "generation._SWAP_LOCK", "lockstep.LockstepLeader._lock",
        "speculative._SPARE_LOCK", "serving.InferenceServer._profile_lock",
        "serving._ANSWERS_LOCK"}
    for name in port_only:
        module = name.split(".")[0]
        assert os.path.basename(port[name]) == f"{module}.py", name


def _pool_prefix_sequence(kv_mod, px_mod, lw, device_kw):
    """A pool and its prefix cache built under an active witness: a donor
    registers a prefix and releases, a second request reserves through the
    shared blocks and releases."""
    w = lw.LockWitness()
    lw.activate(w)
    try:
        kv = kv_mod.PagedKVCache(1, 2, 8, block_size=4, num_blocks=16,
                                 **device_kw)
        px = px_mod.PrefixCache(kv)
        prefix = np.arange(8, dtype=np.int64)
        kv.reserve("donor", 8)
        kv.append_tokens("donor", 8)
        px.register("donor", prefix)
        kv.release("donor")
        hit = px.lookup(np.concatenate([prefix, prefix[:4]]))
        kv.reserve("hit", 12, shared=hit.pairs)
        kv.release("hit")
    finally:
        lw.deactivate()
    return w


def test_pool_and_prefix_cache_record_jax_edges():
    import paddle_tpu.inference.kv_cache as jkv
    import paddle_tpu.inference.prefix_cache as jpx
    import paddle_tpu_torch.inference.kv_cache as tkv
    import paddle_tpu_torch.inference.prefix_cache as tpx

    jw = _pool_prefix_sequence(jkv, jpx, JW, {})
    tw = _pool_prefix_sequence(tkv, tpx, TW, {"device": "cpu"})
    assert set(tw.edges) == set(jw.edges)
    assert ("kv_cache.PagedKVCache._lock",
            "prefix_cache.PrefixCache._lock") in tw.edges
    assert tw.inversions == jw.inversions == []
    from paddle_tpu_torch.analysis.threads import lock_order_graph

    assert tw.check_static(lock_order_graph()) == []
