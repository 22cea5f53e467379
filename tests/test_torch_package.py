"""Package-level contracts of the PyTorch port: it imports neither JAX nor
the JAX package, its entry points refuse to fall back to the CPU silently,
the parts not ported yet refuse loudly, and its paged KV bookkeeping walks
in step with the JAX package's on the same reserve / release / evict
sequence."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu_torch.inference import kv_cache as tkv

PKG = pathlib.Path(paddle_tpu_torch.__file__).parent
REPO = PKG.parent


def test_import_leaves_jax_and_paddle_tpu_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as p\n"
        "names = []\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.append(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'paddle_tpu' or "
        "n.startswith('paddle_tpu.'))\n"
        "print(repr(bad))\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, names = out.stdout.strip().splitlines()
    assert bad == "[]"
    walked = set(names.split())
    for mod in ("ops.flash_attention", "nn.functional.flash_attention",
                "nn.clip", "optimizer", "amp", "jit.train",
                "distributed.fleet.meta_parallel", "models.gpt", "bridge",
                "ops.decode_attention", "models.generation",
                "inference.speculative", "inference.serving", "models.llama",
                "models.bert", "models.steps", "nn.functional.activation",
                "nn.functional.norm", "tensor", "autograd",
                "autograd.py_layer", "framework.dtype", "framework.flags",
                "framework.device", "ops.creation", "ops.math",
                "ops.manipulation", "ops.reduction", "ops.indexing",
                "ops.logic", "ops.search", "ops.linalg", "ops.einsum",
                "ops.random", "ops.patch_methods", "ops.parity", "linalg",
                "testing"):
        assert f"paddle_tpu_torch.{mod}" in walked, mod


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [REPO / "chip_smoke.py",
                          REPO / "tools" / "torch_kernel_ab.py",
                          REPO / "tools" / "train_step_ab.py",
                          REPO / "tools" / "smoke_ab.py",
                          REPO / "tools" / "eager_ab.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_names_jax_or_paddle_tpu(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    from paddle_tpu_torch import (
        ContinuousGenerateBatchingPredictor,
        GPTForCausalLM,
        InferenceServer,
        PagedKVCache,
        gpt_tiny,
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    from paddle_tpu_torch import (
        BertForMaskedLM,
        LlamaForCausalLM,
        bert_tiny,
        llama_tiny,
    )
    for cls, cfg in ((LlamaForCausalLM, llama_tiny),
                     (BertForMaskedLM, bert_tiny)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(2, 4, 16)
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousGenerateBatchingPredictor(m)
    gp = ContinuousGenerateBatchingPredictor(m, num_blocks=8, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceServer(gp)
    finally:
        gp.close()


def test_unported_paths_raise_not_implemented():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import functional as F

    gpt2 = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=2, use_rope=False, use_rms_norm=False,
                     use_swiglu=False)
    assert GPTForCausalLM(gpt2, device="cpu")(
        torch.zeros((1, 3), dtype=torch.int64)).shape == (1, 3, 64)  # ported
    x = torch.ones((1, 3, 2, 16))
    with pytest.raises(NotImplementedError, match="window_size"):
        F.flashmask_attention(x, x, x, torch.full((1, 1, 3, 1), 3),
                              window_size=(1, 1))
    for kw in (dict(dropout=0.1), dict(recompute="dots")):
        assert GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                        num_layers=1, num_heads=2, **kw),
                              device="cpu").training
    m = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                                 num_heads=2), device="cpu")
    ids = torch.zeros((1, 3), dtype=torch.int64)
    assert m(ids).shape == (1, 3, 64)         # the cache-free forward runs
    assert m.generate(ids, max_new_tokens=2).shape == (1, 5)    # ported
    x = torch.ones((1, 3, 2, 16))
    out = F.flashmask_attention(x, x, x, torch.full((1, 1, 3, 1), 3),
                                causal=True)                   # ported
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_seeded_weights_are_reproducible():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

    a = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3).state_dict()
    b = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3).state_dict()
    c = GPTForCausalLM(gpt_tiny(), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gpt.embed_tokens.weight"],
                           c["gpt.embed_tokens.weight"])


_STATS = ("live", "free", "evictable", "requests", "live_utilization")


def _walk(cache, oob):
    """One reserve / done / evict / release sequence; returns what an
    observer sees after each operation."""
    seen = []

    def snap(tag, value=None):
        st = cache.check_conservation()
        seen.append((tag, value, cache.free_blocks, cache.evictions,
                     cache.evicted_blocks,
                     tuple(round(st[k], 9) for k in _STATS)))

    snap("a", cache.reserve("a", 20).tolist())
    snap("b", cache.reserve("b", 9).tolist())
    snap("c", cache.reserve("c", 33).tolist())
    cache.append_tokens("a", 12)
    cache.set_length("b", 9)
    snap("len", (cache.length("a"), cache.length("b")))
    cache.mark_done("a")
    cache.mark_done("b")
    snap("done")
    snap("d", cache.reserve("d", 40).tolist())    # evicts a (LRU) then b
    with pytest.raises(oob):
        cache.reserve("e", 200)
    snap("tbl", cache.block_table("d", pad_to=7).tolist())
    cache.release("c")
    snap("e", cache.reserve("e", 17, evict=False).tolist())
    cache.release("d")
    cache.release("e")
    snap("empty")
    return seen


def test_paged_kv_cache_bookkeeping_matches_jax():
    ref = _walk(jkv.PagedKVCache(1, 2, 8, block_size=8, num_blocks=12,
                                 dtype="float32"), jkv.CacheOutOfBlocks)
    got = _walk(tkv.PagedKVCache(1, 2, 8, block_size=8, num_blocks=12,
                                 dtype=torch.float32, device="cpu"),
                tkv.CacheOutOfBlocks)
    assert got == ref


def test_block_allocator_matches_jax():
    a, b = jkv.BlockAllocator(6), tkv.BlockAllocator(6)
    for alloc in (a, b):
        x = alloc.allocate(2)
        y = alloc.allocate(3)
        alloc.free(x)
        alloc.free(y[:1])
    assert (a.allocate(3), a.available) == (b.allocate(3), b.available)
    for alloc, err in ((a, jkv.CacheOutOfBlocks), (b, tkv.CacheOutOfBlocks)):
        with pytest.raises(err):
            alloc.allocate(5)
        with pytest.raises(ValueError):
            alloc.free([0, 0] if 0 not in alloc._live else [6])


def test_pools_are_updated_in_place():
    cache = tkv.PagedKVCache(2, 2, 8, block_size=4, num_blocks=3,
                             dtype=torch.float32, device="cpu")
    pools = list(cache.k_pages), list(cache.v_pages)
    cache.commit(*pools)                       # own pools: accepted
    with pytest.raises(ValueError):
        cache.commit([p.clone() for p in pools[0]], pools[1])
    rid = "r"
    cache.reserve(rid, 6)
    cache.append_tokens(rid, 5)
    cache.k_pages[1][:, cache.block_table(rid)[1], 0] = 7.0
    k, v = cache.gather(rid, 1)
    assert k.shape == (5, 2, 8) and v.shape == (5, 2, 8)
    assert (k[4] == 7.0).all() and (k[:4] == 0).all()
    assert np.isfinite(v.numpy()).all()
