"""The pure helpers of ``chip_smoke.py`` (the port's measurement script),
on the CPU: the per-kernel register and spill summary it reads from the
``nvcc -Xptxas -v`` log, the record that sets dq + dk/dv against the
library's one backward call, and the serve_knobs phase's chat traffic,
Prometheus line pattern and near-tie cut; the model families' FLOP counts
(``forward_flops`` held to ``torch.utils.flop_counter`` on tiny models of
each family), the D = 128 bounds, the served-rows gate and the kernels
line's D = 128 readings; the resnet50 phase's MAC count (held to the flop
counter) and its control flow rehearsed at a toy size."""
import json
import pathlib
import sys

import pytest

import dist_ranks

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__4af27cb8_18_flash\
_attention_cu_62ae58a722flash_dkv_wgmma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3\
_S3_S3_PKfS5_PS1_S6_PKiiifiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__4af27cb8_18_flash\
_attention_cu_62ae58a722flash_dkv_wgmma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3\
_S3_S3_PKfS5_PS1_S6_PKiiifiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123split_kv_combine\
_kernelI13__nv_bfloat16Li128EEEvPKfS3_S3_PT_iiiiiii' for 'sm_90a'
    16 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 32 registers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121paged_partials\
_kernelIfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_Z10foo_kerneliPf' for 'sm_90a'
ptxas info    : Used 12 registers
"""


def test_ptxas_summary_names_each_kernel_with_its_arguments():
    assert chip_smoke.ptxas_summary(_LOG) == [
        ("flash_dkv_wgmma_kernel<64,1>", 168, 0),
        ("split_kv_combine_kernel<bf16,128>", 32, 36),
        ("paged_partials_kernel<float,64>", 128, 0),
        ("foo_kernel", 12, 0)]
    assert chip_smoke.ptxas_summary("nvcc: nothing compiled\n") == []


@pytest.mark.parametrize("masked", [False, True])
def test_whole_backward_sets_dq_plus_dkv_against_the_library(masked,
                                                             capsys):
    def rec(ms, bound, unmasked):
        r = dict(ms=ms, library_ms=0.25, library_call="sdpa backward",
                 bound_ms=bound)
        if masked:
            r["unmasked_ms"] = unmasked
        return r

    out = chip_smoke.whole_backward(
        {"dq": rec(0.1, 0.02, 0.3), "dkv": rec(0.15, 0.03, 0.4),
         "fwd": rec(9.0, 9.0, 9.0)}, B=1, S=64)
    assert out["kernel"] == "dq+dkv" and (out["B"], out["S"]) == (1, 64)
    assert out["ms"] == pytest.approx(0.25)
    assert out["over_library"] == pytest.approx(1.0)
    assert out["bound_ms"] == pytest.approx(0.05)
    assert out["library_call"] == "sdpa backward"
    if masked:
        assert out["unmasked_ms"] == pytest.approx(0.7)
    else:
        assert "unmasked_ms" not in out
    assert capsys.readouterr().out.startswith("backward-time {")


def test_chat_sessions_fit_the_pool_and_share_the_system_prompt():
    import numpy as np

    system, plan = chip_smoke.chat_sessions(np.random.default_rng(31),
                                            50304)
    assert system.shape == (chip_smoke.KNOB_SYSTEM,)
    motifs = {tuple(system[i:i + 8]) for i in range(0, len(system), 8)}
    assert len(motifs) <= 4                 # repeated motifs: drafts
    assert len(plan) == chip_smoke.KNOB_SESSIONS
    turns = [t for sess in plan for t in sess]
    assert len(turns) == 16 and sum(t["sampled"] for t in turns) == 4
    for sess in plan:
        assert 32 <= len(sess[0]["user"]) <= 200
        assert all(8 <= len(t["user"]) <= 16 for t in sess[1:])
        assert all(16 <= t["new"] <= 64 for t in sess)
        # the last turn's prompt plus the server cap fits max_seq_len
        last = (len(system) + sum(len(t["user"]) for t in sess)
                + sum(t["new"] for t in sess[:-1]))
        assert last + 64 <= 1024


def test_prometheus_sample_pattern():
    from paddle_tpu_torch.observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.counter("paddle_a_total", "x", labels=("k",)).labels('q"\\').inc()
    reg.histogram("paddle_h_seconds", "h").observe(0.3)
    reg.gauge("paddle_g", "g").set(float("nan"))
    lines = reg.render().splitlines()
    assert all(ln.startswith("# ") or chip_smoke.PROM_SAMPLE.match(ln)
               for ln in lines)
    for bad in ("paddle_a_total{k=q} 1", "paddle a 1", "paddle_a_total",
                'paddle_a_total{k="v"} one'):
        assert not chip_smoke.PROM_SAMPLE.match(bad), bad


def test_first_tie_counts_the_tokens_before_a_near_tie(monkeypatch):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import gpt as tgpt

    m = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
        max_position=32), device="cpu", seed=0)
    seq = np.arange(12, dtype=np.int64) % 64
    monkeypatch.setattr(chip_smoke, "NEAR_TIE_REL", 0.0)
    assert chip_smoke.first_tie(torch, m, seq, 5, "cpu") == 7
    monkeypatch.setattr(chip_smoke, "NEAR_TIE_REL", 10.0)
    assert chip_smoke.first_tie(torch, m, seq, 5, "cpu") == 0


def test_prefix_rows_check_holds_indexed_rows_and_fails_a_swapped_page():
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor,
        PagedKVCache,
    )
    from paddle_tpu_torch.models import gpt as tgpt

    m = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
        max_position=64), device="cpu", seed=0)
    kv = PagedKVCache(*m._decode_cache_spec(), block_size=8, num_blocks=24,
                      dtype=torch.float32, device="cpu")
    gp = ContinuousGenerateBatchingPredictor(
        m, kv_cache=kv, device="cpu", max_slots=2, prefill_chunk=4,
        decode_steps=2, max_new_tokens=6, max_seq_len=40, spec_k=2,
        drafter="ngram", prefix_cache=True)
    rng = np.random.default_rng(3)
    system = np.tile(rng.integers(0, 96, 4), 4).astype(np.int64)
    try:
        outs = [gp.infer(np.concatenate(
            [system, rng.integers(0, 96, 7)]).astype(np.int64), timeout=60)
            for _ in range(2)]
    finally:
        gp.close()
    assert gp.metrics.get("prefix_hit_tokens") == 16   # the second request
    rec = chip_smoke.prefix_rows_check(torch, m, kv, gp.prefix_cache, outs,
                                       "cpu", chunk=4, swap=2)
    assert rec["blocks"] == [3, 3] and rec["shared_prompt_pages_common"]
    assert max(rec["rel"]) < 1e-5
    assert rec["control"] > chip_smoke.INSITU_REL_TOL


def _tiny(kind):
    from paddle_tpu_torch.models import bert, gpt, llama

    if kind == "llama":
        cfg = llama.LlamaConfig(vocab_size=96, hidden_size=64, num_layers=2,
                                num_heads=4, num_kv_heads=2,
                                intermediate_size=80)
        return cfg, llama.LlamaForCausalLM(cfg, device="cpu")
    if kind == "bert":
        cfg = bert.BertConfig(vocab_size=96, hidden_size=64, num_layers=2,
                              num_heads=4, intermediate_size=80,
                              max_position=32, dropout=0.0)
        return cfg, bert.BertForMaskedLM(cfg, device="cpu")
    gpt2 = kind == "gpt2"
    cfg = gpt.GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=80, max_position=32,
                        use_rope=not gpt2, use_rms_norm=not gpt2,
                        use_swiglu=not gpt2, tie_embeddings=not gpt2)
    return cfg, gpt.GPTForCausalLM(cfg, device="cpu")


@pytest.mark.parametrize("kind", ["llama", "bert", "gpt", "gpt2"])
def test_forward_flops_count_each_family_s_products(kind):
    """The products of a forward on the CPU, where the attention's plain
    version computes every (row, column) pair, equal ``forward_flops``
    with all S^2 pairs; the causal count is the triangle (BERT: all)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cfg, model = _tiny(kind)
    model.eval()
    B, S = 2, 12
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros((B, S), dtype=torch.int64))
    family = "gpt" if kind.startswith("gpt") else kind
    assert counter.get_total_flops() == chip_smoke.forward_flops(
        family, cfg, B, S, pairs=S * S)
    D = cfg.hidden_size // cfg.num_heads
    causal_gap = (cfg.num_layers * 4 * D * cfg.num_heads * B
                  * (S * S - S * (S + 1) // 2))
    want = counter.get_total_flops() - (0 if kind == "bert" else causal_gap)
    assert chip_smoke.forward_flops(family, cfg, B, S) == want
    assert chip_smoke.step_flops(family, cfg, B, S) == 3 * want


def test_full_size_flops_read_off_the_published_shapes():
    """LLaMA-2-7B's products: 6.48 B weights in products (the 6.74 B less
    the 131 M embedding rows); gpt3_1p3b's GELU MLP has two matrices, not
    SwiGLU's three; bert_base's decoder is the tied 30522 x 768."""
    from paddle_tpu_torch.models import bert, gpt, llama

    c = llama.llama2_7b()
    assert chip_smoke.matmul_params("llama", c) == (
        32 * (4 * 4096 ** 2 + 3 * 4096 * 11008) + 32000 * 4096)
    g = gpt.gpt3_1p3b()
    assert chip_smoke.matmul_params("gpt", g) == (
        24 * (4 * 2048 ** 2 + 2 * 2048 * 8192) + 50304 * 2048)
    b = bert.bert_base()
    assert chip_smoke.matmul_params("bert", b) == (
        12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 768 ** 2 + 30522 * 768)
    # the older GPT count holds for LLaMA too, apart from the norm weights
    # it counts as products (2 h per layer: 4e-5 of the total)
    assert chip_smoke.step_flops("llama", c, 1, 2048) == pytest.approx(
        chip_smoke.gpt_step_flops(c, 1, 2048), rel=1e-4)


def test_d128_bounds_of_the_llama_shapes():
    """llama_serve's decode and llama_generate's prefill (bytes: the live
    K/V rows at 32 kv heads of 128, q and the output) and llama_train's
    flash kernels (operations at the bf16 peak)."""
    import numpy as np

    lengths = np.array([100, 0, 1500, 7, 64, 128, 1999, 30])
    ms, by = chip_smoke.attention_bound(8, 1, 32, 32, 128, 64, 32, lengths,
                                        2, "bfloat16")
    kv = 2 * int((lengths + 1).sum()) * 32 * 128 * 2
    io = 2 * 8 * 32 * 128 * 2 + (8 * 64 + 8) * 4
    assert by == "bytes"
    assert ms == pytest.approx((kv + io) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = chip_smoke.dense_bound(4, 512, 32, 32, 128, 640,
                                    np.zeros(4, np.int64), 2, "bfloat16")
    nbytes = 2 * 4 * 512 * 32 * 128 * 2 * 2 + 4 * 4     # K, V, q, out
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    bounds = chip_smoke.flash_bounds(1, 2048, 32, 128, True)
    pairs = 32 * 2048 * 2049 // 2
    for kern, products in (("fwd", 2), ("dq", 3), ("dkv", 4)):
        assert bounds[kern][1] == "operations"
        assert bounds[kern][0] == pytest.approx(
            2 * 128 * pairs * products / 989e12 * 1e3)
    # bert_base's non-causal forward: its q, k, v, out and lse bytes
    noncausal = chip_smoke.flash_bounds(32, 512, 12, 64, False)
    tile = 32 * 512 * 12 * 64 * 2
    assert noncausal["fwd"] == pytest.approx(
        ((4 * tile + 32 * 12 * 512 * 4) / chip_smoke.HBM_BYTES_PER_S * 1e3,
         "bytes"))


def test_kernels_line_d128_readings_carry_time_bound_and_error():
    timing = {f"{form}_d128": dict(ms=1.0, plain_ms=2.0, bound_ms=0.5,
                                   bound_by="bytes", library_ms=3.0,
                                   extra=9)
              for form in ("decode", "prefill")}
    checked = {form: dict(max_abs_err=1e-3, err_over_limit=0.2)
               for form in ("decode", "prefill")}
    got = chip_smoke.d128_reading(timing, checked)
    assert set(got) == {"decode", "prefill"}
    assert set(got["decode"]) == set(chip_smoke.READING_KEYS) | {
        "max_abs_err", "err_over_limit"}
    flash = chip_smoke.flash_reading(timing["decode_d128"],
                                     checked["decode"])
    assert flash["library_ms"] == 3.0 and "extra" not in flash


def test_served_rows_check_holds_rewritten_rows_and_fails_a_swap():
    import numpy as np
    import torch

    _, model = _tiny("llama")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 96, n).astype(np.int64) for n in (70, 100)]
    rec = chip_smoke.served_rows_check(torch, model, "cpu", seqs, chunk=16)
    assert rec["blocks"] == [2, 3]
    assert max(rec["rel"]) < 1e-6
    assert rec["control"] > chip_smoke.INSITU_REL_TOL


@pytest.fixture
def one_thread():
    """torch on one CPU thread within the test: the conv net legs share
    the machine with the other test workers, and torch's own threads would
    oversubscribe it."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_conv_linear_macs_equal_the_flop_counter_on_resnet50(monkeypatch,
                                                             one_thread):
    """The resnet50 phase's FLOPs: its MAC count from the layers' shapes is
    half of ``torch.utils.flop_counter``'s forward count (2 per MAC) on
    the same forward, and ResNet-50's published 4.09 GMACs at 224 x 224."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import device as pdev

    monkeypatch.setitem(pdev._current, "place", pdev._current["place"])
    P.set_device("cpu")
    model = P.vision.models.resnet50(num_classes=1000, data_format="NHWC")
    model.eval()
    x = P.Tensor(torch.randn(1, 224, 224, 3))
    macs = chip_smoke.conv_linear_macs(torch, model, x)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    assert 2 * macs == counter.get_total_flops()
    assert macs == 4_089_184_256


def test_resnet50_phase_rehearses_on_the_cpu(monkeypatch, one_thread):
    """The resnet50 phase's control flow at B 2, 32 x 32 on the CPU (its
    card calls stubbed, a dummy capture), over ResNet-18 (the same
    blocks' code at a quarter of the work): bodies and the "captured" steps
    run the same code, so their losses, parameters, velocities and
    statistics are equal; the layout check agrees. The rate is 1e-3 here:
    at this toy size the card's 0.1 drives the logits past f32's range
    within five steps."""
    import types

    import torch

    import paddle_tpu_torch as P
    import paddle_tpu_torch.jit.train as train
    from paddle_tpu_torch import optimizer

    class SlowMomentum(optimizer.Momentum):
        def __init__(self, learning_rate, *args, **kwargs):
            super().__init__(1e-3, *args, **kwargs)

    monkeypatch.setattr(optimizer, "Momentum", SlowMomentum)
    monkeypatch.setattr(P.vision.models, "resnet50", P.vision.models.resnet18)

    monkeypatch.setattr(chip_smoke, "RESNET_B", 2)
    monkeypatch.setattr(chip_smoke, "RESNET_HW", 32)
    monkeypatch.setattr(chip_smoke, "RESNET_EVAL_B", 2)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "profile_call",
                        lambda torch, fn, attention=(): (fn(), {})[1])
    monkeypatch.setattr(chip_smoke, "resnet_profile",
                        lambda torch, fn: dict(device_ms_by_kind={}))
    monkeypatch.setattr(chip_smoke, "replay_device_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "pool_bytes", lambda *a: 0)
    real = train.TrainStep._program

    def program(self, args, kwargs):
        prog = real(self, args, kwargs)
        prog.capture = prog.capture or types.SimpleNamespace(graph=None,
                                                             seconds=0.0)
        return prog

    monkeypatch.setattr(train.TrainStep, "_program", program)
    rec = chip_smoke.resnet50_phase(torch, "cpu", timed=2)
    assert rec["replay_losses_equal_body"] and not rec["replay_state_unequal"]
    assert rec["compared_tensors"] == 164 and rec["bn_statistics_compared"] \
        == 40
    assert len(rec["losses"]) == 5 and len(rec["body_losses"]) == 3
    assert rec["layout_check"]["rel"] < chip_smoke.RESNET_LAYOUT_TOL


def test_smoke_ab_sets_the_shared_readings_side_by_side():
    """``tools/smoke_ab.py`` compares the time, rate and share leaves that
    every turn's record holds: ratio of the sides' means, the larger
    turn-to-turn spread, and "apart" only where the sides do not
    overlap."""
    sys.path.insert(0, str(pathlib.Path(chip_smoke.__file__).parent
                           / "tools"))
    import smoke_ab

    def rec(body, tok, rate):
        return {"training": {"body_step_ms": body, "losses": [1.0],
                             "replay_equals_body": True},
                "serving": {"decode_tok_per_s": tok, "requests": 12},
                "resnet50": {"images_per_s": rate},
                "kernels": [{"ms": 1.0}]}

    table = smoke_ab.compare([("other", rec(100.0, 10.0, 5.0)),
                              ("this", rec(120.0, 10.5, 5.0)),
                              ("this", rec(130.0, 9.5, 5.0)),
                              ("other", rec(110.0, 11.0, 5.0))])
    assert set(table) == {"training.body_step_ms",
                          "serving.decode_tok_per_s",
                          "resnet50.images_per_s"}
    body = table["training.body_step_ms"]
    assert body["other"] == [100.0, 110.0] and body["this"] == [120.0, 130.0]
    assert body["ratio"] == pytest.approx(125.0 / 105.0)
    assert body["spread"] == pytest.approx(10.0 / 105.0)
    assert body["apart"]
    assert not table["serving.decode_tok_per_s"]["apart"]
    assert table["resnet50.images_per_s"]["spread"] == 0.0


def test_eager_ab_reads_the_pairs():
    """``tools/eager_ab.py`` sums up its alternating windows per form: each
    side's quartiles, the ratio of the medians and the pairs the change
    took longer in."""
    sys.path.insert(0, str(pathlib.Path(chip_smoke.__file__).parent
                           / "tools"))
    import eager_ab

    windows = [({f: 10.0 + i for f in eager_ab.FORMS},
                {f: 10.0 + i + (1.0 if i < 3 else -1.0)
                 for f in eager_ab.FORMS}) for i in range(4)]
    rec = eager_ab.summarise(windows)
    assert set(rec) == set(eager_ab.FORMS)
    body = rec["train_body"]
    assert body["other"] == [10.75, 11.5, 12.25]
    assert body["this"] == [11.75, 12.0, 12.25]
    assert body["ratio"] == 12.0 / 11.5
    assert body["this_slower_pairs"] == 3 and body["pairs"] == 4


def _stub_card(monkeypatch):
    """The card-only calls of a phase stubbed for a CPU rehearsal, and a
    dummy capture record on every TrainStep program."""
    import types

    import torch

    import paddle_tpu_torch.jit.train as train

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "profile_call",
                        lambda torch, fn, attention=(): (fn(), dict(
                            device_busy_share=None, host_launch_calls=0,
                            device_ms=None, device_ms_by_kind={}))[1])
    real = train.TrainStep._program

    def program(self, args, kwargs):
        prog = real(self, args, kwargs)
        prog.capture = prog.capture or types.SimpleNamespace(graph=None,
                                                             seconds=0.0)
        return prog

    monkeypatch.setattr(train.TrainStep, "_program", program)


def test_rnn_lm_phase_rehearses_on_the_cpu(monkeypatch, one_thread):
    """The rnn_lm phase's control flow with the large PTB LSTM cut to a toy
    (vocab 50, hidden 8, 5 steps, batch 3): bodies and the "captured"
    steps run the same code from the same state and generator seed, so
    losses and parameters are equal and the dropout masks too; the hook's
    LSTM output equals the eager layer's; the beam search's ids equal the
    plain beam search's."""
    import torch

    from paddle_tpu_torch.framework import device as pdev

    _stub_card(monkeypatch)
    monkeypatch.setitem(pdev._current, "place", pdev._current["place"])
    monkeypatch.setattr(chip_smoke, "RNN_LM", dict(
        chip_smoke.RNN_LM, vocab=50, hidden=8, steps=5, batch=3))
    rec = chip_smoke.rnn_lm(torch, "cpu", warmup=1, timed=2, decode_B=2,
                            decode_T=6)
    assert rec["replay_losses_equal_body"]
    assert rec["replay_params_max_abs_diff"] == 0.0
    assert rec["captured_lstm_output_max_abs_diff"] == 0.0
    assert rec["decode"]["ids_equal_plain"]
    assert len(rec["losses"]) == 3


def test_rnn_lm_model_is_the_published_configuration():
    """RNN_LM is the large PTB model of arXiv:1409.2329: 2 x 1500 LSTM over
    a 10k vocabulary, 35 steps, batch 20, dropout 0.65, init 0.04, SGD 1.0,
    clip 10; its parameter count is the paper's ~66 M."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import device as pdev

    c = chip_smoke.RNN_LM
    assert (c["vocab"], c["hidden"], c["layers"], c["steps"], c["batch"]) \
        == (10000, 1500, 2, 35, 20)
    assert (c["dropout"], c["init"], c["lr"], c["clip"]) == (0.65, 0.04,
                                                             1.0, 10.0)
    prev = pdev._current["place"]
    P.set_device("cpu")
    try:
        small = chip_smoke.rnn_lm_model(P, dict(c, vocab=10, hidden=4))
        names = sorted(k for k, _ in small.named_parameters())
    finally:
        pdev._current["place"] = prev
    assert names[0] == "embed.weight" and "lstm.cells.1.bias_hh" in names
    H, V = c["hidden"], c["vocab"]
    count = 2 * V * H + V + 2 * (4 * H * (H + H) + 8 * H)
    assert 65e6 < count < 67e6


def test_o2_autocast_leg_rehearses_on_the_cpu(monkeypatch):
    """The o2_autocast leg of train_recipes on a tiny GPT: bodies and the
    "captured" steps equal, the loss f32 under auto_cast(O2), the replay
    outside auto_cast equal to one inside, 3 flash calls (the plain
    versions here, counted as launches) per layer and step."""
    import torch

    import paddle_tpu_torch.ops.flash_attention as fa
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    _stub_card(monkeypatch)
    for kind, name in (("fwd", "flash_attention_fwd_ref"),
                       ("dq", "flash_attention_dq_ref"),
                       ("dkv", "flash_attention_dkv_ref")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _kind=kind, **k):
            fa._WRAPPERS[_kind].launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, name, counted)
    monkeypatch.setattr(chip_smoke, "LEGLESS_PEAK_BYTES", 1)
    model = GPTForCausalLM(GPTConfig(vocab_size=128, hidden_size=64,
                                     num_layers=2, num_heads=4,
                                     max_position=32), device="cpu", seed=3)
    amp.decorate(model, level="O2", dtype="bfloat16")
    ids_np = torch.randint(0, 128, (2, 16), generator=torch.Generator()
                           .manual_seed(0))
    labels = torch.roll(ids_np, -1, 1)
    rec = chip_smoke.recipe_leg(torch, fa, model, ids_np, labels,
                                "o2_autocast", "bfloat16", 2, 2, o2=True)
    assert rec["amp"].startswith("O2 decorate + auto_cast(O2)")
    assert rec["loss_dtype"] == "float32"
    assert rec["outside_auto_cast_equal"]
    assert rec["replay_losses_equal_body"]
    assert rec["kernel_launches"]["fwd"] == 2 * 4
    assert not amp.is_auto_cast_enabled()


def test_nn_fillin_cases_rehearse_on_the_cpu(one_thread):
    """The core phase's nn fill-ins (CPU against CPU here: the control
    flow, every case's outputs and gradients, the integer outputs)."""
    import torch

    rec = chip_smoke.nn_fillins(torch, "cpu", capture=False)
    assert rec["cases"] == 16
    assert rec["worst"] == {"float64": 0.0, "float32": 0.0}


def test_script_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, one_thread):
    """The script phase's control flow at a toy size on the CPU: a GPT of
    2 layers, 16 windows of 8 tokens (8 steps), the fresh processes run
    in this one (``script_worker``, SIGTERM included), the serving process
    stood in for by its record (the next test runs ``SERVE_SCRIPT``). What
    only the card gives is reported as failing, and nothing else: no
    capture here (the step runs as its body), and the served program's
    kernel launches."""
    import torch

    from paddle_tpu_torch.framework import device as pdev
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa

    _stub_card(monkeypatch)
    for name in ("memory_allocated", "max_memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "replay_device_ms",
                        lambda torch, graph, reps=10: 0.0)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "SCRIPT_DIR", str(tmp_path / "script"))
    monkeypatch.setitem(pdev._current, "place", pdev._current["place"])
    pdev.set_device("cpu")
    monkeypatch.setattr(gpt, "gpt_350m", lambda: gpt.GPTConfig(
        vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
        max_position=32))
    for kind, name in (("fwd", "flash_attention_fwd_ref"),
                       ("dq", "flash_attention_dq_ref"),
                       ("dkv", "flash_attention_dkv_ref")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _kind=kind, **k):
            fa._WRAPPERS[_kind].launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, name, counted)
    c = dict(chip_smoke.SCRIPT, B=2, S=8, windows=16, eval_windows=4)

    def worker(mode, ckpt_dir, timeout=240):
        out = str(tmp_path / f"{mode}.json")
        try:
            chip_smoke.script_worker(mode, ckpt_dir, out, c, "cpu")
            code = 0
        except SystemExit as e:
            code = e.code
        import json

        with open(out) as f:
            return code, json.load(f), 0.0

    monkeypatch.setattr(chip_smoke, "run_script_worker", worker)
    real_run = chip_smoke.subprocess.run

    def serve(cmd, **kw):
        if cmd[1] != "-c":
            return real_run(cmd, **kw)
        import json
        import subprocess

        rec = {f"b{n}_{k}": v for n in (8, 2) for k, v in (
            ("launches", 0), ("finite", True), ("max_abs_diff", 0.0),
            ("max_abs_ref", 1.0), ("shape", [n, 8, 96]))}
        rec.update(load_s=0.0, predictor_ms=0.0, program_ms=0.0,
                   peak_bytes=0, modules=[])
        with open(cmd[6], "w") as f:
            json.dump(rec, f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", serve)
    with pytest.raises(AssertionError) as ei:
        chip_smoke.script_phase(torch, fa, "cpu", {"step_ms": 1.0}, c)
    fails = str(ei.value).split("; ")
    assert fails[0].startswith("script phase: fit took the eager route "
                               "or captured again: 0 captures")
    assert [f.split(":")[0] for f in fails[1:]] == ["served b8",
                                                    "served b2"], fails


@pytest.fixture(scope="module")
def served_toy(tmp_path_factory):
    """``SERVE_SCRIPT``'s record for a toy bf16 GPT exported on the CPU
    (run once: a fresh process's start is most of it)."""
    import json
    import subprocess

    import numpy as np
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import gpt

    tmp = tmp_path_factory.mktemp("serve")
    net = gpt.GPTForCausalLM(gpt.GPTConfig(
        vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
        max_position=32), device="cpu", dtype=torch.bfloat16, seed=1).eval()
    ids = np.random.default_rng(1).integers(0, 96, (8, 16))
    with torch.no_grad():
        ref = net(torch.from_numpy(ids))
    np.save(tmp / "ref.npy", ref.view(torch.int16).numpy())
    np.save(tmp / "ids.npy", ids)
    art = str(tmp / "export" / "gpt")
    P.jit.save(net, art, input_spec=[P.static.InputSpec([None, 16],
                                                        "int64")])
    out = str(tmp / "serve.json")
    r = subprocess.run([sys.executable, "-c", chip_smoke.SERVE_SCRIPT, art,
                        str(tmp / "ref.npy"), str(tmp / "ids.npy"), out,
                        "cpu"], capture_output=True, text=True, timeout=240,
                       cwd=chip_smoke.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def test_serve_script_runs_an_export_on_the_cpu(served_toy):
    """``SERVE_SCRIPT`` (the script phase's serving process) on a toy bf16
    GPT exported on the CPU: it loads the export through
    ``create_predictor``, holds both batches' logits to the eager
    forward's (bit-equal here: the same ops on the same device), and
    imports nothing of JAX or the JAX package."""
    rec = served_toy
    assert rec["b8_shape"] == [8, 16, 96] and rec["b2_shape"] == [2, 16, 96]
    assert rec["b8_max_abs_diff"] == rec["b2_max_abs_diff"] == 0.0
    assert rec["b8_finite"] and rec["b2_finite"] and rec["modules"] == []
    assert rec["b8_launches"] == rec["b2_launches"] == 0     # plain on CPU


def test_serve_production_phase_rehearses_on_the_cpu(monkeypatch,
                                                     one_thread):
    """The serve_production phase's control flow and every gate with
    GPT-350M cut to a toy (2 layers, hidden 64, vocab 160; 4 slots, chunk
    8, block 8, 8 new tokens, two adapters) and the card's peak stubbed
    in: base traffic
    bit-identical without a registry, adapters equal to merged weights in
    f32 (through the LoRA scheduler, a speculative LoRA scheduler and LoRA
    generate_paged), no program built after warmup under churn, a gold
    arrival pausing a free sequence with tokens unchanged, conserved
    utilization, the HTTP taxonomy, a healed thread death and a refused
    torn load, two replicas with two programs each (nothing is captured on
    the CPU)."""
    import torch

    import paddle_tpu_torch.observability as obs
    import paddle_tpu_torch.observability.utilization as ut
    import paddle_tpu_torch.models.gpt as tgpt
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa

    _stub_card(monkeypatch)
    peak = chip_smoke.PEAK_FLOPS["bfloat16"]
    for mod in (obs, ut):
        monkeypatch.setattr(mod, "device_peak_flops", lambda dev: peak)
    for name in ("paged_decode_attention", "paged_decode_attention_ref"):
        def counted(*a, _f=getattr(tgpt, name), **k):
            pa.paged_decode_attention.launches += 1     # stands in for one
            return _f(*a, **k)

        monkeypatch.setattr(tgpt, name, counted)
    cfg = GPTConfig(vocab_size=160, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_position=256)
    model = GPTForCausalLM(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    rec = chip_smoke.serve_production(torch, model, "cpu", p=dict(
        slots=4, chunk=8, block_size=8, max_seq_len=256, new=8,
        requests=8, free=4, spec_k=2, rate_requests=4, adapters=2,
        turns=("base", "lora", "monitored")))
    assert rec["base_bit_identical"]
    assert rec["preemption"]["paused"] >= 1
    assert rec["launches_per_forward"] == 2
    assert rec["fleet"]["keys_per_replica"] == [2, 2]
    assert rec["http"]["metered"]["status"] == 429
    assert rec["utilization"]["peak_flops"] == peak
    assert set(rec["adapters_vs_merged_f32"]) == {"ad0", "ad1"}
    assert all(r["speculative_equal"] and r["generate_paged_equal"]
               for r in rec["adapters_vs_merged_f32"].values())
    spec = rec["lora_paths"]["speculative"]
    assert spec["lora_verify"] and spec["launches"] == 2 * spec["forwards"]
    assert rec["lora_paths"]["generate_paged"]["launches"] == 2 * 8 * 2
    assert set(rec["adapters_over_base"]) == {"ratio", "spread", "resolved"}


def _count_flash_refs(monkeypatch):
    """The plain flash versions count into their kernels' wrappers, as the
    kernels would on the card."""
    from paddle_tpu_torch.ops import flash_attention as fa

    for kind, name in (("fwd", "flash_attention_fwd_ref"),
                       ("dq", "flash_attention_dq_ref"),
                       ("dkv", "flash_attention_dkv_ref")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _kind=kind, **k):
            fa._WRAPPERS[_kind].launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, name, counted)
    return fa


def test_train_monitor_phase_rehearses_on_the_cpu(monkeypatch, one_thread):
    """The train_monitor phase's control flow on a 2-layer GPT (B 2, S
    16): monitored losses equal the bare step's, launches equal, the
    sentinel's new_shape and aot_fallback, one planted NaN one anomaly,
    the seams' table; only the card's gauges fail (no peak FLOP/s for the
    CPU, so no MFU; no allocator peak)."""
    import torch

    from paddle_tpu_torch.framework import device as pdev
    from paddle_tpu_torch.models.gpt import GPTConfig

    _stub_card(monkeypatch)
    fa = _count_flash_refs(monkeypatch)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setitem(pdev._current, "place", pdev._current["place"])
    pdev.set_device("cpu")
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                    num_heads=4, max_position=32)
    with pytest.raises(AssertionError) as ei:
        chip_smoke.train_monitor(torch, fa, "cpu", B=2, S=16, steps=3,
                                 rounds=1, turn_steps=1, cfg=cfg)
    fails = str(ei.value).split("; ")
    assert len(fails) == 1, fails
    assert fails[0].startswith("train_monitor: live MFU or HBM gauges "
                               "missing: {'mfu': None"), fails


def test_monitor_readings_time_each_batch_begin_to_end():
    """The script phase's batch reading: each ``data_wait`` span's end (a
    batch's begin) to the next ``callbacks`` span's end (its end), beside
    the step spans (``h2d`` start to ``step`` end)."""
    from paddle_tpu_torch.observability import StepMonitor

    mon = StepMonitor()
    rec = mon.tracer.record
    rec("h2d", 100, 104, None, tags={"step": 1})
    rec("step", 104, 140, None, tags={"step": 1})
    mon.record_phase("callbacks", 140, 150)
    mon.record_phase("data_wait", 150, 170)
    rec("h2d", 175, 180, None, tags={"step": 2})
    rec("step", 180, 200, None, tags={"step": 2})
    mon.record_phase("callbacks", 200, 215)
    mon.record_phase("data_wait", 215, 230)
    mon.record_phase("callbacks", 290, 300)
    got = chip_smoke.monitor_readings(mon)
    assert got["step_s"] == [40e-6, 25e-6]
    assert got["batch_s"] == [45e-6, 70e-6]
    assert got["data_wait_s"] == [20e-6, 15e-6]


def test_incubate_phase_rehearses_on_the_cpu(monkeypatch, one_thread):
    """The incubate phase's gates (g)-(k) at a toy size on the CPU: the
    fused stack against the nn stack and the functionals, the O2 table and
    the tensor checker, the bf16 stack's bodies against its "captured"
    steps under a monitor, MoE index against dense, ASP on a 2-layer GPT,
    LookAhead and ModelAverage against hand loops: all hold."""
    import torch

    from paddle_tpu_torch.framework import device as pdev
    from paddle_tpu_torch.models.gpt import GPTConfig

    _stub_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "time_ms", lambda torch, fn, flush,
                        reps=25, queued=True: (fn(), 0.0)[1])
    monkeypatch.setitem(pdev._current, "place", pdev._current["place"])
    rec = chip_smoke.incubate_phase(
        torch, "cpu", B=2, S=8, d=16, heads=2, ff=32, layers=2, steps=2,
        moe_shape=(2, 16, 16, 4, 32),
        asp_config=GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                             num_heads=4, max_position=32))
    assert rec["g"]["fused_vs_nn"] <= rec["g"]["limit"]
    assert rec["h"]["equal"] and rec["h"]["monitor_steps"] == 2
    assert all(r["l_aux_equal"] for r in rec["i"]["seeds"])
    assert len(rec["i"]["seeds"]) == 3
    assert rec["i"]["worst_rel"] <= rec["i"]["bound"]
    assert rec["j"]["all_sparse"] and rec["j"]["pruned"] == 8
    assert all(rec["k"].values())


def test_paired_ratio_takes_each_round_as_one_ratio():
    """Rounds of turns (den, num, num, den): a drift within a round
    cancels, so a steady 1% cost reads as 0.99 in every round."""
    rates = {"bare": [100.0, 106.0, 200.0, 212.0],
             "monitored": [100.98, 102.96, 201.96, 205.92]}
    got = chip_smoke.paired_ratio(rates, "monitored", "bare")
    assert got["rounds"] == pytest.approx([0.99, 0.99])
    assert got["spread"] == pytest.approx(0.0, abs=1e-12)
    assert got["resolved"] and got["cost_at_most"] == pytest.approx(0.01)
    naive = chip_smoke.rate_ratio(rates, "monitored", "bare")
    assert not naive["resolved"]


@pytest.fixture(scope="module")
def distributed_rehearsal():
    """The distributed phase at two gloo ranks on a tiny GPT (fresh
    processes, ~30 s on the CPU: a fixture's, outside the call budget)."""
    with dist_ranks.spawn_lock():
        return chip_smoke.distributed_phase(world=2, device="cpu",
                                            tiny=True, timeout=240)


def test_distributed_phase_rehearses_on_the_cpu(distributed_rehearsal):
    """Every collective holds, the DataParallel TrainStep's mean loss is
    the bare step's on the whole batch, the lockstep scheduler under
    serving_mesh(dp=1, tp=2) gives the whole model's tokens, and the head
    shards and Ulysses hold to their plain versions."""
    rec = distributed_rehearsal
    assert rec["world"] == 2 and rec["backend"] == "gloo"
    assert all(rec["collectives"].values())
    assert rec["train"]["ok"] and rec["train"]["max_rel_diff"] <= 1e-5
    assert rec["train"]["param_gap"] <= 1e-3
    assert rec["train"]["data_parallel"]["syncs"] == 14   # 4 + 10 timed
    assert rec["serve"]["tp"] == 2 and rec["serve"]["tokens_equal"]
    assert rec["serve"]["lockstep"]
    assert (rec["serve"]["pool_per_chip_bytes"] * 2
            == rec["serve"]["pool_bytes"])
    assert set(rec["shards"]) == {
        f"{k}_tp{tp}" for k in ("paged_decode", "paged_prefill",
                                "ulysses_flash_fwd") for tp in (2, 4)}
    assert rec["ulysses"]["ok"] and not rec["failures"]


def test_launcher_and_auto_parallel_rehearse_on_the_cpu(
        distributed_rehearsal):
    """The phase's ranks come from the port's launcher over its native
    store (heartbeats sent and seen, exit code 0), and the auto_parallel
    leg (``parallelize`` with the GPT plan, every key matched, ZeRO-2 over
    the two ranks; ``to_static``) holds the bare step's losses within
    1e-5 and every leaf's gap within 1e-3."""
    rec = distributed_rehearsal
    la = rec["launcher"]
    assert la["ok"] and la["server"] == "native" and la["exit_code"] == 0
    assert la["heartbeats"] >= 1 and la["heartbeat_seen"]
    assert la["ranks"] == 2 and la["attempt"] == 0
    ap = rec["auto_parallel"]
    assert ap["ok"] and not ap["unmatched_keys"]
    assert ap["max_rel_diff"] <= 1e-5 and ap["param_gap"] <= 1e-3
    assert ap["zero_stage"] == 2 and ap["zero_group_ranks"] == 2
    assert len(ap["losses"]) == ap["steps"] == 4
    assert ap["predicted_launches"] == {k: 2 * 4 for k in ("fwd", "dq",
                                                            "dkv")}


def test_moe_ep_sync_bn_and_rpc_legs_rehearse_on_the_cpu(
        distributed_rehearsal):
    """The worker's last three legs at two ranks: the expert-parallel MoE
    layer over the world group (two experts a rank; each rank's output the
    no-group layer's on its tokens, four all-to-alls a fwd + bwd);
    SyncBatchNorm under DataParallel against the bare BatchNorm model on
    the whole batch (f32: mean loss within 1e-5, the state within 1e-3 of
    how far it moved); rpc round trips over the launcher's native
    store, to this rank and to the next."""
    rec = distributed_rehearsal
    moe = rec["moe_ep"]
    assert moe["ok"] and moe["ranks"] == 2 and moe["ep_local_experts"] == 2
    assert moe["a2a_launches"] == 4 and moe["out_rel"] <= 1e-5
    bn = rec["sync_bn"]
    assert bn["ok"] and bn["sync"]["kinds"] == ["SyncBatchNorm"]
    assert bn["max_rel_diff"] <= 1e-5 and bn["param_gap"] <= 1e-3
    rpc = rec["rpc"]
    assert rpc["ok"] and rpc["server"] == "native"
    assert rpc["workers"] == ["worker0", "worker1"]
    for leg in (moe, bn, rpc):
        assert leg["wall_s"] < 10


def test_pipeline_phase_rehearses_on_the_cpu(distributed_rehearsal):
    """The pipeline phase at pp 2 over the two gloo ranks (each rank one
    stage of the tiny gpt3-style GPT): every schedule's losses and this
    rank's parameters against the unpipelined accumulation; ZeRO 1-3
    under TrainStep at dp 2 against the bare step; the ZeRO-1 checkpoint
    round trip bit-equal and the next step equal."""
    pipe = distributed_rehearsal["pipeline"]
    gpt = pipe["gpt"]
    assert gpt["stages"] == 2 and gpt["ok"]
    assert set(gpt["schedules"]) == {"1F1B", "Eager1F1B", "FThenB", "ZB-H1",
                                     "VPP2"}
    for name, r in gpt["schedules"].items():
        assert r["ok"] and r["max_loss_diff"] <= max(r["loss_limit"]), name
        assert r["model_gap"] <= 1e-2 and r["param_gap"] <= 0.25, name
        assert r["chunks"] == ([0, 2] if name == "VPP2" else [0]), name
        # rank 0 holds chunk 0 (and 2): the plain flash versions ran there
        assert r["predicted_per_step"]["fwd"] > 0
    assert gpt["schedules"]["ZB-H1"]["schedule"] == "ZB-H1"
    # the control (micro-batch 0's backward dropped) fails the parameter
    # gate on its own
    ctl = gpt["control_skip_backward"]
    assert gpt["control_failed"] and not ctl["params_ok"]
    assert ctl["model_gap"] > 1e-2 or ctl["param_gap"] > 0.25
    zero = pipe["zero"]
    for k in ("zero1", "zero2", "zero3"):
        assert zero["stages"][k]["ok"], k
        assert zero["stages"][k]["sliced"] > 0
    ck = zero["checkpoint"]
    assert ck["ok"] and ck["params_bit_equal"] and ck["opt_bit_equal"]
    assert ck["next_params_bit_equal"] and ck["bytes"] > 0


@pytest.fixture(scope="module")
def pipeline_skipped_shared_sum():
    """The rehearsal with the tied weight's gradient left unsummed across
    its two stages: the failure message, or None if it passed."""
    try:
        with dist_ranks.spawn_lock():
            chip_smoke.distributed_phase(world=2, device="cpu", tiny=True,
                                         plant="skip_shared_sum",
                                         timeout=240)
    except AssertionError as e:
        return str(e)
    return None


def test_pipeline_phase_fails_when_the_shared_sum_is_skipped(
        pipeline_skipped_shared_sum):
    """Each stage's copy of the tied embedding takes only its own use's
    gradient: the copies leave the unpipelined run's weights (the token
    table's gap near 0.75) and the gate refuses every schedule."""
    msg = pipeline_skipped_shared_sum
    assert msg is not None and "failed checks" in msg
    bad = json.loads(msg.split("failed checks ", 1)[1])
    for rank in ("0", "1"):
        gpt = bad[rank]["pipeline.gpt"]
        assert not gpt["ok"]
        for name, r in gpt["schedules"].items():
            assert not r["ok"], name
            # the worst leaf is the shared layer's (its token table, or on
            # the last stage its learned positions, which that copy's use
            # never reads)
            assert r["worst_leaf"].startswith("run_function.0.shared."), name
            assert r["param_gap"] > 0.25, name


@pytest.fixture(scope="module")
def distributed_skipped_sync():
    """The rehearsal with DataParallel's gradient sync planted away: the
    failure message of the phase, or None if it passed."""
    try:
        with dist_ranks.spawn_lock():
            chip_smoke.distributed_phase(world=2, device="cpu", tiny=True,
                                         plant="skip_sync", timeout=240)
    except AssertionError as e:
        return str(e)
    return None


def test_distributed_phase_fails_when_the_sync_is_skipped(
        distributed_skipped_sync):
    """Gradients left local on each rank: the parameters leave the bare
    step's (the gap near 1) and the gate refuses the phase."""
    msg = distributed_skipped_sync
    assert msg is not None and "failed checks" in msg
    bad = json.loads(msg.split("failed checks ", 1)[1])
    train = bad["0"]["train"]
    assert not train["ok"] and train["param_gap"] > 0.1
    assert train["data_parallel"]["syncs"] == 0


@pytest.fixture(scope="module")
def distributed_raised():
    """The rehearsal with the last rank raising: the failure message of
    the phase, or None if it passed (a fixture's launch, outside the call
    budget)."""
    try:
        with dist_ranks.spawn_lock():
            chip_smoke.distributed_phase(world=2, device="cpu", tiny=True,
                                         plant="raise", timeout=240)
    except AssertionError as e:
        return str(e)
    return None


def test_distributed_phase_fails_when_a_rank_raises(distributed_raised):
    """A rank that raises fails the phase through the launcher's exit
    code (the launcher tears its pod down) instead of hanging it."""
    msg = distributed_raised
    assert msg is not None and "exit codes" in msg
    assert "launcher exit code 1" in msg
