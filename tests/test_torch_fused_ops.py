"""The incubate fused ops and layers of the port against the JAX package on
the CPU: ``tests/test_fused_ops.py``'s bodies on both packages (each
package also against the composed numpy reference), the port's outputs and
gradients held to JAX's on the same inputs, ``fused_rotary_position_embedding``
in both styles (tables at 0..S-1, per row from ``position_ids``, given as
[S, D] tables, given tables taken at ``position_ids``), the fused layers
(``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, pre- and post-LN) on the same weights,
and the two gelu forms: the functional's tanh form and the layer's exact
one, each equal to JAX's (ROADMAP C). Tolerance: f32, 1e-5 relative and
1e-6 absolute (sums in another order); against numpy 1e-4 / 1e-5, as JAX's
test has it.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from port_bodies import jax_results, npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])
TOL = dict(rtol=1e-5, atol=1e-6)


def _IF(P):
    return P.incubate.nn.functional


def _ln(x, eps=1e-5):
    m = x.mean(-1, keepdims=True)
    v = x.var(-1, keepdims=True)
    return (x - m) / np.sqrt(v + eps)


def _mha_body(P):
    rng = np.random.default_rng(0)
    B, S, E, H = 2, 6, 16, 4
    hd = E // H
    x = rng.standard_normal((B, S, E)).astype("float32")
    qkv_w = (rng.standard_normal((3, H, hd, E)) * 0.1).astype("float32")
    qkv_b = (rng.standard_normal((3, H, hd)) * 0.1).astype("float32")
    lin_w = (rng.standard_normal((E, E)) * 0.1).astype("float32")
    lin_b = (rng.standard_normal((E,)) * 0.1).astype("float32")
    got = npy(_IF(P).fused_multi_head_attention(
        P.to_tensor(x), P.to_tensor(qkv_w), P.to_tensor(lin_w),
        pre_layer_norm=True, qkv_bias=P.to_tensor(qkv_b),
        linear_bias=P.to_tensor(lin_b), num_heads=H))
    h = _ln(x)
    qkv = np.einsum("bse,thde->bsthd", h, qkv_w) + qkv_b[None, None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scores = np.einsum("bshd,bthd->bhst", q, k) / np.sqrt(hd)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    ctx = np.einsum("bhst,bthd->bshd", p, v).reshape(B, S, E)
    want = x + (ctx @ lin_w + lin_b)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the [embed, 3 * embed] layout of the same weights
    w_t = qkv_w.reshape(3 * E, E).T.copy()
    got_t = npy(_IF(P).fused_multi_head_attention(
        P.to_tensor(x), P.to_tensor(w_t), P.to_tensor(lin_w),
        pre_layer_norm=True, qkv_bias=P.to_tensor(qkv_b.reshape(-1)),
        linear_bias=P.to_tensor(lin_b), num_heads=H, transpose_qkv_wb=True))
    np.testing.assert_allclose(got_t, want, rtol=1e-4, atol=1e-5)
    return {"out": got, "out_t": got_t}


@PKG
def test_fused_mha_matches_composed_reference(pkg, on_cpu):
    run(_mha_body, pkg, **TOL)


def _mha_post_ln_body(P):
    rng = np.random.default_rng(1)
    B, S, E, H = 1, 4, 8, 2
    x = rng.standard_normal((B, S, E)).astype("float32")
    qkv_w = (rng.standard_normal((3, H, E // H, E)) * 0.1).astype("float32")
    lin_w = (rng.standard_normal((E, E)) * 0.1).astype("float32")
    mask = np.full((B, H, S, S), 0.0, "float32")
    mask[..., 2:] = -1e9
    out = npy(_IF(P).fused_multi_head_attention(
        P.to_tensor(x), P.to_tensor(qkv_w), P.to_tensor(lin_w),
        pre_layer_norm=False, attn_mask=P.to_tensor(mask), num_heads=H,
        ln_scale=P.to_tensor(np.full(E, 2.0, "float32")),
        ln_bias=P.to_tensor(np.full(E, 0.5, "float32"))))
    np.testing.assert_allclose(out.mean(-1), 0.5, atol=1e-5)
    np.testing.assert_allclose(out.var(-1), 4.0, atol=4e-3)
    no_res = npy(_IF(P).fused_multi_head_attention(
        P.to_tensor(x), P.to_tensor(qkv_w), P.to_tensor(lin_w),
        pre_layer_norm=False, attn_mask=P.to_tensor(mask), num_heads=H,
        add_residual=False))
    return {"out": out, "no_res": no_res}


@PKG
def test_fused_mha_post_ln_and_mask(pkg, on_cpu):
    run(_mha_post_ln_body, pkg, **TOL)


def _ffn_body(P):
    rng = np.random.default_rng(2)
    B, S, E, I = 2, 4, 8, 16
    x = rng.standard_normal((B, S, E)).astype("float32")
    w1 = (rng.standard_normal((E, I)) * 0.1).astype("float32")
    w2 = (rng.standard_normal((I, E)) * 0.1).astype("float32")
    b1 = (rng.standard_normal((I,)) * 0.1).astype("float32")
    b2 = (rng.standard_normal((E,)) * 0.1).astype("float32")
    T = P.to_tensor
    got = npy(_IF(P).fused_feedforward(
        T(x), T(w1), T(w2), linear1_bias=T(b1), linear2_bias=T(b2),
        pre_layer_norm=True, activation="relu", dropout1_rate=0.0,
        dropout2_rate=0.0))
    want = x + (np.maximum(_ln(x) @ w1 + b1, 0) @ w2 + b2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    P.seed(0)
    with_do = npy(_IF(P).fused_feedforward(
        T(x), T(w1), T(w2), pre_layer_norm=True, activation="relu",
        dropout1_rate=0.9, dropout2_rate=0.0, training=True))
    no_do = npy(_IF(P).fused_feedforward(
        T(x), T(w1), T(w2), pre_layer_norm=True, activation="relu",
        dropout1_rate=0.0, dropout2_rate=0.0, training=True))
    assert not np.allclose(with_do, no_do)
    outs = {"relu": got, "no_do": no_do}
    for act in ("gelu", "silu"):
        outs[act] = npy(_IF(P).fused_feedforward(
            T(x), T(w1), T(w2), linear1_bias=T(b1), linear2_bias=T(b2),
            pre_layer_norm=False, activation=act, dropout1_rate=0.0,
            dropout2_rate=0.0, ln2_scale=T(np.full(E, 1.5, "float32"))))
    return outs


@PKG
def test_fused_feedforward_matches_composed(pkg, on_cpu):
    run(_ffn_body, pkg, **TOL)


def _dropout_add_body(P):
    x = P.to_tensor(np.ones((64, 64), "float32"))
    y = P.to_tensor(np.full((64, 64), 5.0, "float32"))
    out_eval = npy(_IF(P).fused_dropout_add(x, y, p=0.5, training=False))
    np.testing.assert_allclose(out_eval, 6.0)
    P.seed(0)
    out_train = npy(_IF(P).fused_dropout_add(x, y, p=0.5, training=True))
    kept = out_train != 5.0
    assert 0.3 < kept.mean() < 0.7
    np.testing.assert_allclose(out_train[kept], 5.0 + 2.0)
    return {"eval": out_eval}


@PKG
def test_fused_dropout_add(pkg, on_cpu):
    run(_dropout_add_body, pkg, **TOL)


def _mha_grad_body(P):
    rng = np.random.default_rng(3)
    B, S, E, H = 1, 4, 8, 2
    x = P.to_tensor(rng.standard_normal((B, S, E)).astype("float32"),
                    stop_gradient=False)
    qkv_w = P.to_tensor((rng.standard_normal((3, H, E // H, E)) * 0.1
                         ).astype("float32"), stop_gradient=False)
    lin_w = P.to_tensor((rng.standard_normal((E, E)) * 0.1).astype(
        "float32"))
    out = _IF(P).fused_multi_head_attention(x, qkv_w, lin_w,
                                            pre_layer_norm=True, num_heads=H)
    out.sum().backward()
    gx, gw = npy(x.grad), npy(qkv_w.grad)
    assert np.any(gx != 0) and np.any(gw != 0)
    return {"gx": gx, "gw": gw}


@PKG
def test_fused_mha_gradient_flows(pkg, on_cpu):
    run(_mha_grad_body, pkg, rtol=1e-5, atol=1e-5)


def test_cache_kv_and_ring_id_raise(on_cpu):
    IF = _IF(paddle_tpu_torch)
    T = paddle_tpu_torch.to_tensor
    x = T(np.zeros((1, 2, 4), "float32"))
    w = T(np.zeros((3, 1, 4, 4), "float32"))
    lin = T(np.zeros((4, 4), "float32"))
    with pytest.raises(NotImplementedError, match="cache_kv"):
        IF.fused_multi_head_attention(x, w, lin, cache_kv=x)
    with pytest.raises(NotImplementedError, match="ring_id"):
        IF.fused_multi_head_attention(x, w, lin, ring_id=0)
    with pytest.raises(NotImplementedError, match="ring_id"):
        IF.fused_feedforward(x, lin, lin, ring_id=1)


# ------------------------------------------------------------- RoPE
def _rope_body(P):
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 6, 2, 8
    q = rng.standard_normal((B, S, H, D)).astype("float32")
    k = rng.standard_normal((B, S, H, D)).astype("float32")
    pos = np.stack([np.arange(S) + 3, np.arange(S)]).astype("int64")
    ang = np.arange(S)[:, None] / (10000.0 ** (np.arange(0, D, 2) / D))
    emb = np.concatenate([ang, ang], -1).astype("float32")
    T = P.to_tensor
    rope = _IF(P).fused_rotary_position_embedding
    out = {}
    for neox in (True, False):
        tag = "neox" if neox else "inter"
        a = rope(T(q), T(k), use_neox_rotary_style=neox)
        out[f"{tag}_q"], out[f"{tag}_k"] = npy(a[0]), npy(a[1])
        assert a[2] is None
        b = rope(T(q), position_ids=T(pos), use_neox_rotary_style=neox)
        out[f"{tag}_pos"] = npy(b[0])
        assert b[1] is None and b[2] is None
        c = rope(T(q), T(k), T(k), sin=T(np.sin(emb)), cos=T(np.cos(emb)),
                 use_neox_rotary_style=neox)
        out[f"{tag}_given_v"] = npy(c[2])
        d = rope(T(q), sin=T(np.sin(emb)), cos=T(np.cos(emb)),
                 position_ids=T(pos % S), use_neox_rotary_style=neox)
        out[f"{tag}_given_pos"] = npy(d[0])
    # a row at position 0 is not rotated; tables at 0..S-1 equal row 1's
    np.testing.assert_allclose(out["neox_pos"][1], out["neox_q"][1],
                               rtol=1e-6, atol=1e-6)
    return out


@PKG
def test_fused_rotary_position_embedding(pkg, on_cpu):
    run(_rope_body, pkg, **TOL)


def test_rope_matches_the_models_rotation(on_cpu):
    """The neox form with per-row positions is the models' apply_rope over
    rope_cos_sin."""
    import torch

    IF = _IF(paddle_tpu_torch)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 2, 8, generator=g)
    pos = torch.tensor([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    want = IF.apply_rope(q, *IF.rope_cos_sin(pos, 8, torch.float32))
    got, _, _ = IF.fused_rotary_position_embedding(q, position_ids=pos)
    assert torch.equal(got, want)


# ------------------------------------------------------------- the layers
def _layer_body(kind, pre_ln, activation="relu"):
    def body(P):
        inc = P.incubate.nn
        P.seed(0)
        E, H, FF = 16, 4, 32
        if kind == "mha":
            layer = inc.FusedMultiHeadAttention(
                E, H, dropout_rate=0.0, attn_dropout_rate=0.0,
                normalize_before=pre_ln)
        elif kind == "ffn":
            layer = inc.FusedFeedForward(E, FF, dropout_rate=0.0,
                                         activation=activation,
                                         normalize_before=pre_ln)
        else:
            layer = inc.FusedTransformerEncoderLayer(
                E, H, FF, dropout_rate=0.0, activation=activation,
                normalize_before=pre_ln)
        rng = np.random.default_rng(5)
        layer.set_state_dict({k: (rng.standard_normal(tuple(v.shape)) * 0.2
                                  + (1.0 if "ln" in k and "weight" in k
                                     else 0.0)).astype("float32")
                              for k, v in sorted(layer.state_dict().items())})
        x = P.to_tensor(rng.standard_normal((2, 5, E)).astype("float32"),
                        stop_gradient=False)
        mask = np.zeros((2, 1, 5, 5), "float32")
        mask[..., 3:] = -1e9
        out = (layer(x, attn_mask=P.to_tensor(mask)) if kind == "mha"
               else layer(x, src_mask=P.to_tensor(mask)) if kind == "enc"
               else layer(x))
        out.sum().backward()
        res = {"out": npy(out), "gx": npy(x.grad)}
        for name, p in layer.named_parameters():
            # a layer's unused norm (pre_ln after, ln before) has none
            res["g_" + name] = (npy(p.grad) if p.grad is not None
                                else "none")
        return res
    body.__name__ = f"layer_{kind}_{pre_ln}_{activation}"
    return body


LAYER_BODIES = {(k, pre, act): _layer_body(k, pre, act)
                for k in ("mha", "ffn", "enc") for pre in (False, True)
                for act in (("relu", "gelu") if k != "mha" else ("relu",))}


@pytest.fixture(scope="module", params=sorted(LAYER_BODIES),
                ids=lambda c: "-".join(map(str, c)))
def layer_case(request):
    """A layer body with JAX's answer computed in the setup."""
    jax_results(LAYER_BODIES[request.param])
    return request.param


def test_fused_layers_equal_jax(layer_case, on_cpu):
    run(LAYER_BODIES[layer_case], "torch", rtol=1e-5, atol=1e-5)


def test_two_gelu_forms_differ_as_in_jax(on_cpu):
    """The functional FFN's gelu is the tanh form, the layer's the exact
    one (ROADMAP C): on the same weights the two differ, in both
    packages, by the same amount."""
    def body(P):
        P.seed(0)
        layer = P.incubate.nn.FusedFeedForward(8, 16, dropout_rate=0.0,
                                               activation="gelu",
                                               normalize_before=True)
        rng = np.random.default_rng(6)
        sd = {k: (rng.standard_normal(tuple(v.shape)) * 0.5).astype(
            "float32") for k, v in sorted(layer.state_dict().items())}
        layer.set_state_dict(sd)
        x = rng.standard_normal((2, 3, 8)).astype("float32") * 3
        T = P.to_tensor
        fn = npy(_IF(P).fused_feedforward(
            T(x), T(sd["linear1.weight"]), T(sd["linear2.weight"]),
            linear1_bias=T(sd["linear1.bias"]),
            linear2_bias=T(sd["linear2.bias"]), ln1_scale=T(sd["ln.weight"]),
            ln1_bias=T(sd["ln.bias"]), dropout1_rate=0.0, dropout2_rate=0.0,
            activation="gelu", pre_layer_norm=True))
        lay = npy(layer(T(x)))
        assert np.abs(fn - lay).max() > 1e-5
        return {"fn": fn, "layer": lay}

    run(body, "torch", **TOL)
