"""The lint model zoo: the port's own flagship programs, traced and linted —
the counterpart of ``paddle_tpu/analysis/zoo.py``.

One place builds the programs ``--self-check`` and the tests gate on:

* ``gpt_train`` / ``resnet_train`` — a GPT smoke ``TrainStep`` (AdamW) and
  a ResNet-18 one (Momentum), traced as their next call would run them;
* ``gpt_decode_dense`` — ``generate()``'s two programs (prefill, decode);
* ``gpt_decode_paged`` — ``generate_paged()`` over a pool sized past the
  donation threshold (the port writes it in place on every device, so it
  lints clean with no allowlist entry);
* ``gpt_prefill_chunk`` / ``gpt_decode_step`` / ``gpt_verify_step`` — the
  continuous scheduler's step programs, one slot live and one idle;
* ``gpt_prefill_prefix`` — the chunked prefill entered through a prefix
  hit (same program, traced offsets);
* ``gpt_*_lora`` — the three step programs with the banked LoRA gather;
* ``gpt_prefill_chunk_tp`` / ``gpt_decode_step_tp`` /
  ``gpt_verify_step_tp`` — the three step programs traced at tp = 2 inside
  ``comms.tp_world`` (a fake process group of two ranks in this process,
  nothing sent): the row- and vocab-parallel layers' all-reduces and the
  sampled-logits gather are c10d nodes, which ``collective-axis`` holds to
  the serving mesh's groups;
* ``compile_surface`` — the program-inventory contract
  (``compilesurface.py``) and the zoo cross-check;
* ``hbm_residency`` — the residency contract (``hbm.py``);
* ``comms_surface`` — the comms contract (``comms.py``): the step programs'
  collective inventory at tp = 2 and the five comms rules.

Smoke sizes on purpose, JAX's geometry (vocab 512, hidden 64, 2 layers, 4
heads): findings are properties of the graph, not of the weights. Every
entry takes ``device``: None picks the card when there is one, else the
CPU; on the card the programs are traced over fake CUDA tensors.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .core import Thresholds, analyze_runner, analyze_train_step

__all__ = ["ZOO_PROGRAMS", "zoo_report", "zoo_reports", "zoo_device"]


def zoo_device(device=None) -> torch.device:
    """``device``, or the card when there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextlib.contextmanager
def _place(device):
    """Within: the port's current place is ``device`` (Layers build their
    parameters there); the previous one comes back after."""
    from ..framework import device as fdev

    prev = fdev._current["place"]
    fdev.set_device(str(device))
    try:
        yield
    finally:
        fdev._current["place"] = prev


def _gpt_smoke(device=None):
    from ..models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                    num_heads=4, max_position=128)
    return cfg, GPTForCausalLM(cfg, device=zoo_device(device), seed=0)


def gpt_train_report(thresholds=None, allowlist=None, device=None):
    from ..jit.train import TrainStep
    from ..optimizer import AdamW

    cfg, model = _gpt_smoke(device)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = TrainStep(model, lambda logits, loss: loss, opt)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    x = torch.from_numpy(ids.astype("int64")).to(model.device)
    y = torch.from_numpy(np.roll(ids, -1, axis=1).astype("int64")).to(
        model.device)
    return analyze_train_step(step, x, labels=y, name="train_step:GPT",
                              thresholds=thresholds, allowlist=allowlist)


def resnet_train_report(thresholds=None, allowlist=None, device=None):
    from .. import nn
    from ..jit.train import TrainStep
    from ..optimizer import Momentum
    from ..vision.models import resnet18

    dev = zoo_device(device)
    with _place(dev):
        model = resnet18(num_classes=10)
        loss_fn = nn.CrossEntropyLoss()
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        step = TrainStep(model, lambda out, y: loss_fn(out, y), opt)
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(2, 3, 32, 32).astype("float32")).to(dev)
        y = torch.from_numpy(rs.randint(0, 10, 2).astype("int64")).to(dev)
        return analyze_train_step(step, x, y, name="train_step:ResNet18",
                                  thresholds=thresholds, allowlist=allowlist)


def gpt_decode_dense_report(thresholds=None, allowlist=None, device=None):
    cfg, model = _gpt_smoke(device)
    model.eval()
    B, P, NEW = 2, 8, 4
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    model.generate(torch.from_numpy(ids).to(model.device),
                   max_new_tokens=NEW, dtype="bfloat16", temperature=0.8,
                   top_k=4)
    run = model.compiled_generate_runner(B, P, NEW)
    # the sampler's knobs are buffer inputs: one program serves greedy and
    # sampled requests, so this lints the sampled branch too
    return analyze_runner(model, run, name="gpt.decode.dense",
                          programs=("prefill", "decode"),
                          thresholds=thresholds, allowlist=allowlist)


def _smoke_pool(cfg, model, block_size=128, num_blocks=128):
    from ..inference.kv_cache import PagedKVCache

    # each pool past the 1 MiB donation threshold, so donation-miss judges
    # it (the port writes it in place: no finding, no allowlist entry)
    return PagedKVCache(cfg.num_layers, cfg.num_kv_heads,
                        cfg.hidden_size // cfg.num_heads,
                        block_size=block_size, num_blocks=num_blocks,
                        dtype="bfloat16", device=model.device)


def gpt_decode_paged_report(thresholds=None, allowlist=None, device=None):
    cfg, model = _gpt_smoke(device)
    model.eval()
    B, P, NEW = 2, 8, 4
    kv = _smoke_pool(cfg, model)
    plens = np.full((B,), P, np.int64)
    for i in range(B):
        kv.reserve(i, P + NEW)
    nb = kv.blocks_for(P + NEW)
    tbl = np.stack([kv.block_table(i, pad_to=nb) for i in range(B)])
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    model.generate_paged(ids, plens, kv, tbl, max_new_tokens=NEW)
    run = model.compiled_generate_paged_runner(B, P, NEW)
    return analyze_runner(model, run, name="gpt.decode.paged",
                          thresholds=thresholds, allowlist=allowlist)


def _continuous_smoke(device=None):
    """A smoke GPT plus a pool past the donation threshold, one slot live
    and one idle — the masked-slot configuration the scheduler runs."""
    cfg, model = _gpt_smoke(device)
    model.eval()
    S, C, NEW, T = 2, 8, 4, 2
    kv = _smoke_pool(cfg, model)
    kv.reserve("seq", C + NEW)
    nb = kv.blocks_for(C + NEW)
    tbl = np.zeros((S, nb), np.int32)
    tbl[0] = kv.block_table("seq", pad_to=nb)
    ids = np.zeros((S, C), np.int64)
    ids[0] = np.random.RandomState(0).randint(0, cfg.vocab_size, C)
    return model, kv, tbl, ids, S, C, NEW, T


def _tp_entry(report_fn):
    """The entry ``report_fn`` at tp = 2: built and traced inside
    ``comms.tp_world``, its collectives declared over the serving mesh's
    groups."""
    def report(thresholds=None, allowlist=None, device=None):
        from ..distributed.mesh import get_mesh
        from .comms import tp_world

        with tp_world(2):
            mesh = get_mesh()
            groups = {a: mesh.get_group(a) for a in mesh.dim_names}
            return report_fn(thresholds, allowlist, device, _tp=groups)
    report.__name__ = report_fn.__name__.replace("_report", "_tp_report")
    return report


def _tp_name(name, groups):
    return name + ("_tp" if groups else "")


def gpt_prefill_chunk_report(thresholds=None, allowlist=None, device=None,
                             _tp=None):
    model, kv, tbl, ids, S, C, NEW, T = _continuous_smoke(device)
    offs = np.zeros(S, np.int64)
    lens = np.asarray([C, 0], np.int64)          # slot 1 idle (masked)
    model.prefill_chunk(ids, offs, lens, kv, tbl)   # builds the runner
    run = model.compiled_prefill_chunk_runner(S, C)
    return analyze_runner(model, run,
                          name=_tp_name("gpt.decode.paged_prefill_chunk", _tp),
                          mesh_axes=_tp, thresholds=thresholds,
                          allowlist=allowlist)


def gpt_decode_step_report(thresholds=None, allowlist=None, device=None,
                           _tp=None):
    model, kv, tbl, ids, S, C, NEW, T = _continuous_smoke(device)
    model.prefill_chunk(ids, np.zeros(S, np.int64),
                        np.asarray([C, 0], np.int64), kv, tbl)
    tok = np.zeros(S, np.int64)
    lens = np.asarray([C, 0], np.int64)
    act = np.asarray([True, False])
    lmax = np.asarray([C + NEW, 0], np.int64)
    model.decode_step(tok, lens, act, kv, tbl, steps=T, max_lens=lmax)
    run = model.compiled_decode_step_runner(S, T)
    return analyze_runner(model, run,
                          name=_tp_name("gpt.decode.paged_step", _tp),
                          mesh_axes=_tp, thresholds=thresholds,
                          allowlist=allowlist)


def gpt_prefill_prefix_report(thresholds=None, allowlist=None, device=None):
    """Chunked prefill entered through a prefix-cache hit: a donor commits
    a 16-token prefix, registers it and releases (two full blocks park in
    the evictable tier); a second request with that prefix plus 8 novel
    tokens reserves THROUGH the shared blocks and prefills only its suffix
    at offset 16. The program is the cold prefill program (the same key):
    a hit changes only the staged offsets."""
    from ..inference.prefix_cache import PrefixCache

    cfg, model = _gpt_smoke(device)
    model.eval()
    S, BS, PFX, C, NEW = 2, 8, 16, 8, 4
    kv = _smoke_pool(cfg, model, block_size=BS, num_blocks=1024)
    px = PrefixCache(kv)
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, cfg.vocab_size, PFX).astype(np.int64)
    suffix = rs.randint(0, cfg.vocab_size, C).astype(np.int64)
    kv.reserve("donor", PFX)
    kv.append_tokens("donor", PFX)
    px.register("donor", prefix)
    kv.release("donor")
    hit = px.lookup(np.concatenate([prefix, suffix]))
    kv.reserve("hit", PFX + C + NEW, shared=hit.pairs)
    if kv.length("hit") != PFX:
        raise RuntimeError("zoo prefix hit did not attach")
    nb = kv.blocks_for(PFX + C + NEW)
    tbl = np.zeros((S, nb), np.int32)
    tbl[0] = kv.block_table("hit", pad_to=nb)
    ids = np.zeros((S, C), np.int64)
    ids[0] = suffix
    offs = np.asarray([PFX, 0], np.int64)   # resume PAST the shared prefix
    lens = np.asarray([C, 0], np.int64)
    model.prefill_chunk(ids, offs, lens, kv, tbl)
    run = model.compiled_prefill_chunk_runner(S, C)
    return analyze_runner(model, run,
                          name="gpt.decode.paged_prefill_prefix",
                          thresholds=thresholds, allowlist=allowlist)


def gpt_verify_step_report(thresholds=None, allowlist=None, device=None,
                           _tp=None):
    model, kv, tbl, ids, S, C, NEW, T = _continuous_smoke(device)
    model.prefill_chunk(ids, np.zeros(S, np.int64),
                        np.asarray([C, 0], np.int64), kv, tbl)
    K = 3
    chunk = np.zeros((S, K + 1), np.int64)
    chunk[0] = np.random.RandomState(1).randint(0, 512, K + 1)
    model.verify_step(chunk, np.asarray([C, 0], np.int64),
                      np.asarray([K, 0], np.int64),
                      np.asarray([True, False]), kv, tbl,
                      max_lens=np.asarray([C + NEW, 0], np.int64))
    run = model.compiled_verify_step_runner(S, K + 1)
    return analyze_runner(model, run,
                          name=_tp_name("gpt.decode.paged_verify_step", _tp),
                          mesh_axes=_tp, thresholds=thresholds,
                          allowlist=allowlist)


def _continuous_lora_smoke(device=None):
    """The continuous smoke pool with an AdapterRegistry: 4 adapter rows +
    the identity, rank 8, over the smoke GPT's target projections — the
    ("lora", 5, 8, 4) signature of the continuous-lora config. One rank-4
    adapter is routed to the live slot."""
    from ..inference.adapters import AdapterRegistry

    model, kv, tbl, ids, S, C, NEW, T = _continuous_smoke(device)
    reg = AdapterRegistry(model, max_adapters=4, max_rank=8)
    rs = np.random.RandomState(7)
    weights = {}
    for path in reg.target_paths():
        d_in, d_out = reg.dims(path)
        weights[path] = (rs.randn(d_in, 4).astype(np.float32) * 0.02,
                         rs.randn(4, d_out).astype(np.float32) * 0.02)
    row = reg.register("zoo-adapter", weights, alpha=8.0)
    aidx = np.zeros(S, np.int32)
    aidx[0] = row
    return model, kv, tbl, ids, S, C, NEW, T, reg, aidx


def _lora_runner(model, kind, reg):
    """The cached LoRA runner of ``kind`` over registry ``reg``."""
    for key, run in model._runner_cache().items():
        if key[0] == kind and key[-1] == ("bank", reg.uid):
            return run
    raise KeyError(f"no {kind} runner over the registry's bank")


def gpt_prefill_chunk_lora_report(thresholds=None, allowlist=None,
                                  device=None):
    """Chunked prefill with the banked LoRA gather: the adapter index and
    the bank are program inputs, so any adapter mix reuses this program."""
    (model, kv, tbl, ids, S, C, NEW, T,
     reg, aidx) = _continuous_lora_smoke(device)
    model.prefill_chunk(ids, np.zeros(S, np.int64),
                        np.asarray([C, 0], np.int64), kv, tbl,
                        adapters=reg, adapter_slots=aidx)
    return analyze_runner(model, _lora_runner(model, "prefill_chunk", reg),
                          name="gpt.decode.paged_prefill_chunk_lora",
                          thresholds=thresholds, allowlist=allowlist)


def gpt_decode_step_lora_report(thresholds=None, allowlist=None,
                                device=None):
    (model, kv, tbl, ids, S, C, NEW, T,
     reg, aidx) = _continuous_lora_smoke(device)
    model.prefill_chunk(ids, np.zeros(S, np.int64),
                        np.asarray([C, 0], np.int64), kv, tbl,
                        adapters=reg, adapter_slots=aidx)
    model.decode_step(np.zeros(S, np.int64), np.asarray([C, 0], np.int64),
                      np.asarray([True, False]), kv, tbl, steps=T,
                      max_lens=np.asarray([C + NEW, 0], np.int64),
                      adapters=reg, adapter_slots=aidx)
    return analyze_runner(model, _lora_runner(model, "decode_step", reg),
                          name="gpt.decode.paged_step_lora",
                          thresholds=thresholds, allowlist=allowlist)


def gpt_verify_step_lora_report(thresholds=None, allowlist=None,
                                device=None):
    (model, kv, tbl, ids, S, C, NEW, T,
     reg, aidx) = _continuous_lora_smoke(device)
    model.prefill_chunk(ids, np.zeros(S, np.int64),
                        np.asarray([C, 0], np.int64), kv, tbl,
                        adapters=reg, adapter_slots=aidx)
    K = 3
    chunk = np.zeros((S, K + 1), np.int64)
    chunk[0] = np.random.RandomState(1).randint(0, 512, K + 1)
    model.verify_step(chunk, np.asarray([C, 0], np.int64),
                      np.asarray([K, 0], np.int64),
                      np.asarray([True, False]), kv, tbl,
                      max_lens=np.asarray([C + NEW, 0], np.int64),
                      adapters=reg, adapter_slots=aidx)
    return analyze_runner(model, _lora_runner(model, "verify_step", reg),
                          name="gpt.decode.paged_verify_step_lora",
                          thresholds=thresholds, allowlist=allowlist)


def compile_surface_report(thresholds=None, allowlist=None, device=None):
    """The compile-surface contract over the decode programs above, and the
    ZOO_FAMILIES cross-check against this registry."""
    del thresholds, device
    from .compilesurface import analyze_compile_surface, zoo_cross_check

    zoo_cross_check()
    return analyze_compile_surface(allowlist=allowlist,
                                   name="compile.surface")


def hbm_residency_report(thresholds=None, allowlist=None, device=None):
    """The residency contract: the default continuous config's step
    programs estimated (and, on the card, measured) against the smoke
    budget."""
    del thresholds
    from .hbm import analyze_hbm_residency

    return analyze_hbm_residency(allowlist=allowlist, name="hbm.residency",
                                 device=device)


def comms_surface_report(thresholds=None, allowlist=None, device=None):
    """The comms contract: the three continuous step programs traced at
    tp = 2, their collectives inventoried, the SpecLayout contract checked
    and the five comms rules run (``comms.analyze_step_comms``)."""
    del thresholds
    from .comms import analyze_step_comms

    return analyze_step_comms(allowlist=allowlist, name="comms.surface",
                              device=device)


ZOO_PROGRAMS = {
    "gpt_train": gpt_train_report,
    "resnet_train": resnet_train_report,
    "gpt_decode_dense": gpt_decode_dense_report,
    "gpt_decode_paged": gpt_decode_paged_report,
    "gpt_prefill_chunk": gpt_prefill_chunk_report,
    "gpt_prefill_prefix": gpt_prefill_prefix_report,
    "gpt_decode_step": gpt_decode_step_report,
    "gpt_verify_step": gpt_verify_step_report,
    "gpt_prefill_chunk_tp": _tp_entry(gpt_prefill_chunk_report),
    "gpt_decode_step_tp": _tp_entry(gpt_decode_step_report),
    "gpt_verify_step_tp": _tp_entry(gpt_verify_step_report),
    "gpt_prefill_chunk_lora": gpt_prefill_chunk_lora_report,
    "gpt_decode_step_lora": gpt_decode_step_lora_report,
    "gpt_verify_step_lora": gpt_verify_step_lora_report,
    "compile_surface": compile_surface_report,
    "hbm_residency": hbm_residency_report,
    "comms_surface": comms_surface_report,
}


def zoo_report(name, thresholds=None, allowlist=None, device=None):
    return ZOO_PROGRAMS[name](thresholds=thresholds, allowlist=allowlist,
                              device=device)


def zoo_reports(include=None, thresholds=None, allowlist=None, device=None):
    """Lint the bundled programs; returns a list of Reports. ``include``
    restricts to a subset of ``ZOO_PROGRAMS`` keys (default: all)."""
    names = list(ZOO_PROGRAMS) if include is None else list(include)
    th = thresholds or Thresholds()
    return [zoo_report(n, thresholds=th, allowlist=allowlist, device=device)
            for n in names]
