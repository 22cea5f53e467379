"""Flash attention forward and backward — the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py`` (``_mha_fwd``, ``_mha_bwd``,
``_mha_bwd_chunked``, the custom VJP ``_flash`` and the wrapper
``flash_attention``).

Layouts follow the JAX package: q, k, v, out and the gradients are the
paddle layout ``[B, S, H, D]``; ``lse`` and ``delta`` are f32 ``[B * H, S]``.
The kernels read and write ``[B, S, H, D]`` directly, so the wrapper needs
no ``[B * H, S, D]`` transposes (JAX ``_to_bhsd``, :480-488).

* ``flash_attention`` — the wrapper: GQA by ``repeat_interleave`` of the kv
  heads (JAX ``jnp.repeat(kv, n_rep, axis=2)``, :491-494), then
  ``FlashAttentionFunction``, a ``torch.autograd.Function`` whose forward
  runs ``flash_fwd`` and saves ``(q, k, v, out, lse)``, and whose backward
  computes ``delta`` in f32 and runs ``flash_bwd_dq`` and ``flash_bwd_dkv``.
* ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv`` — one per kernel of
  ``csrc/flash_attention.cu``. On CUDA tensors each launches its kernel or
  raises (float32 / bfloat16, head_dim 64 or 128, any S); on CPU tensors
  each runs its plain version. ``.launches`` counts kernel launches.
* ``flash_attention_fwd_ref`` / ``flash_attention_dq_ref`` /
  ``flash_attention_dkv_ref`` / ``flash_attention_bwd_ref`` — the plain
  PyTorch versions: the TPU kernels' arithmetic (``_fwd_kernel`` :89,
  ``_dq_kernel`` :166, ``_dkv_kernel`` :196) over whole rows, rounding where
  they round: P to V's dtype before P.V, p to dO's dtype before dV, ds to
  K's dtype before dq and to Q's before dk; f32 sums, one cast at the end.
  The backward is the explicit formulas, not autograd through a softmax.
* ``kernel_tolerance`` — the elementwise limits a kernel output is held to
  against its plain version, derived from where the two round.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention", "FlashAttentionFunction", "supports",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_attention_fwd_ref", "flash_attention_dq_ref",
           "flash_attention_dkv_ref", "flash_attention_bwd_ref",
           "attention_delta", "kernel_tolerance"]

_NEG = torch.finfo(torch.float32).min
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# Limits of kernel_tolerance: twice the unit roundoff of the storage dtype
# (a value rounded on both sides, or a rounding that flips), and the slack of
# f32 sums taken in another order (~256 ulps of the sum of |terms|).
_ROUND2 = {torch.bfloat16: 2.0 ** -7, torch.float32: 0.0}
_ACC = 2.0 ** -16


def supports(q_shape, k_shape) -> bool:
    """Static check: self-attention ``[B, S, H, D]`` with ``k_shape``'s kv
    heads dividing the query heads. The kernels further take head_dim 64 or
    128 and float32 / bfloat16, and raise on anything else."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    b, s, h, d = q_shape
    return (tuple(k_shape[:2]) == (b, s) and k_shape[3] == d
            and k_shape[2] > 0 and h % k_shape[2] == 0 and 0 < d <= 256)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# ----------------------------------------------------------------- plain
def _heads(x):
    """[B, S, H, D] -> [B, H, S, D] f32 (a view's copy)."""
    return x.transpose(1, 2).float()


def _allowed(S, causal, device):
    """[S, S] bool: query row r may attend key column c."""
    if not causal:
        return torch.ones((S, S), dtype=torch.bool, device=device)
    r = torch.arange(S, device=device)
    return r[:, None] >= r[None, :]


def _probs(q, k, lse, causal, scale):
    """p = exp(s - lse) [B, H, S, S] f32, 0 where masked (TPU :182-187)."""
    s = _heads(q) @ _heads(k).mT * scale
    allowed = _allowed(q.shape[1], causal, q.device)
    s = torch.where(allowed, s, torch.full((), _NEG, device=q.device))
    return torch.exp(s - lse.reshape(s.shape[:-1])[..., None])


def _to_bshd(x, dtype):
    """[B, H, S, D] f32 -> [B, S, H, D] contiguous in ``dtype``."""
    return x.transpose(1, 2).to(dtype).contiguous()


def attention_delta(out, dout):
    """delta = rowsum(dO * O) in f32, [B * H, S] (TPU ``_mha_bwd`` :375)."""
    B, S, H, _ = out.shape
    d = (dout.float() * out.float()).sum(-1)            # [B, S, H]
    return d.transpose(1, 2).reshape(B * H, S).contiguous()


def flash_attention_fwd_ref(q, k, v, causal=False, scale=None):
    """(out [B, S, H, D] in q's dtype, lse [B * H, S] f32): the exact softmax
    of ``_fwd_kernel``: f32 scores, P = exp(s - m) rounded to V's dtype
    before P.V, f32 sums, o / l; 0 and 0 for a row with no allowed column."""
    scale = _scale(q, scale)
    B, S, H, _ = q.shape
    s = _heads(q) @ _heads(k).mT * scale
    allowed = _allowed(S, causal, q.device)
    s = torch.where(allowed, s, torch.full((), _NEG, device=q.device))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = e.to(v.dtype).float() @ _heads(v)
    live = allowed.any(-1)[:, None]                      # [S, 1]
    o = torch.where(live, o / l, torch.zeros((), device=q.device))
    lse = torch.where(live, m + torch.log(l), torch.zeros((), device=q.device))
    return _to_bshd(o, q.dtype), lse.reshape(B * H, S)


def flash_attention_dq_ref(q, k, v, dout, lse, delta, causal=False,
                           scale=None):
    """dq = (p * (dO.V^T - delta) * scale, rounded to K's dtype) . K, in f32,
    cast once to q's dtype (``_dq_kernel``)."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale)
    dp = _heads(dout) @ _heads(v).mT
    ds = p * (dp - delta.reshape(p.shape[:-1])[..., None]) * scale
    return _to_bshd(ds.to(k.dtype).float() @ _heads(k), q.dtype)


def flash_attention_dkv_ref(q, k, v, dout, lse, delta, causal=False,
                            scale=None):
    """(dk, dv): dv = p^T . dO with p rounded to dO's dtype, dk = ds^T . Q
    with ds rounded to Q's dtype, f32 sums cast once (``_dkv_kernel``)."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale)
    do = _heads(dout)
    dp = do @ _heads(v).mT
    ds = p * (dp - delta.reshape(p.shape[:-1])[..., None]) * scale
    dk = ds.to(q.dtype).float().mT @ _heads(q)
    dv = p.to(dout.dtype).float().mT @ do
    return _to_bshd(dk, k.dtype), _to_bshd(dv, v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False,
                            scale=None):
    """(dq, dk, dv) of the plain backward, ``delta`` taken from out."""
    delta = attention_delta(out, dout)
    dq = flash_attention_dq_ref(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv_ref(q, k, v, dout, lse, delta, causal,
                                     scale)
    return dq, dk, dv


def kernel_tolerance(q, k, v, ref, causal=False, scale=None, dout=None,
                     delta=None):
    """Elementwise limits on |kernel - plain| for every output named in
    ``ref`` ("out", "lse", "dq", "dk", "dv": the plain outputs for these
    inputs). ``ref["lse"]`` is always needed; the gradients need ``dout``
    and ``delta`` (or ``ref["out"]`` to take it from). Returns a dict with
    the keys of ``ref``.

    With p the normalised probabilities, smag = scale * max_c |q|.|k_c| the
    size of a row's scores, and r = 2^-7 for bf16 (0 for f32):

    * out: r (|out| + sum_c p |v_c|) — each side rounds every probability
      (the kernel against its running max) and the output to bf16 — plus
      2^-16 (1 + smag) sum_c p |v_c| for f32 sums in another order, scores
      included;
    * lse: 2^-16 (1 + smag + |lse|), both sides in f32;
    * dq: r (|dq| + sum_c |ds| |k_c|) + 2^-16 sum_c dsmag |k_c|, where
      dsmag = p scale (|dO|.|v| + |delta| + |dp - delta| (1 + smag)) bounds
      ds and its f32 noise; dk likewise over the query rows with |q|; dv:
      r (|dv| + sum_r p |dO_r|) + 2^-16 sum_r p (1 + smag) |dO_r|.
    """
    scale = _scale(q, scale)
    r = _ROUND2[q.dtype]
    B, S, H, _ = q.shape
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    allowed = _allowed(S, causal, q.device)
    smag = ((qf.abs() @ kf.abs().mT) * scale * allowed).amax(-1,
                                                             keepdim=True)
    lse = ref["lse"].reshape(B, H, S, 1)
    p = _probs(q, k, ref["lse"], causal, scale)
    lim = {"lse": (_ACC * (1 + smag + lse.abs())).reshape(B * H, S)}
    if "out" in ref:
        mag = p @ vf.abs()
        lim["out"] = _to_bshd(r * (_heads(ref["out"]).abs() + mag)
                              + _ACC * (1 + smag) * mag, torch.float32)
    grads = [n for n in ("dq", "dk", "dv") if n in ref]
    if not grads:
        return lim
    if delta is None:
        delta = attention_delta(ref["out"], dout)
    do = _heads(dout)
    delta = delta.reshape(B, H, S, 1)
    dp = do @ vf.mT
    ds = p * (dp - delta) * scale
    dsmag = p * scale * (do.abs() @ vf.abs().mT + delta.abs()
                         + (dp - delta).abs() * (1 + smag))
    terms = {"dq": lambda: (ds.abs(), dsmag, kf.abs()),
             "dk": lambda: (ds.abs().mT, dsmag.mT, qf.abs()),
             "dv": lambda: (p.mT, (p * (1 + smag)).mT, do.abs())}
    for name in grads:
        a, b, c = terms[name]()
        lim[name] = _to_bshd(r * (_heads(ref[name]).abs() + a @ c)
                             + _ACC * (b @ c), torch.float32)
    return lim


# ---------------------------------------------------------------- kernels
def _kernel_inputs(what, *tensors):
    """Contiguous, 16-byte aligned copies where needed, after checking what
    the kernels take."""
    q = tensors[0]
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} unsupported by the kernel "
                         f"{_HEAD_DIMS}")
    out = []
    for t in tensors:
        if t.shape != q.shape:
            raise ValueError(f"{what}: every tensor must be [B, S, H, D] "
                             f"{tuple(q.shape)} (repeat GQA kv heads first), "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: dtypes differ ({t.dtype} vs "
                            f"{q.dtype})")
        if t.device != q.device:
            raise ValueError(f"{what}: tensors on {t.device} and {q.device}")
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _stats(x, B, H, S, device):
    if x.shape != (B * H, S) or x.dtype != torch.float32:
        raise ValueError(f"lse / delta must be float32 [B*H, S] = "
                         f"[{B * H}, {S}], got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"lse / delta on {x.device}, q on {device}")
    return x.contiguous()


def _check_launch(lib, err, what):
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _device_kind(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {q.device}")
    return q.device.type


def flash_fwd(q, k, v, causal=False, scale=None):
    """(out, lse) of ``flash_fwd_kernel`` on CUDA tensors (q, k, v of one
    shape [B, S, H, D]); ``flash_attention_fwd_ref`` on CPU tensors."""
    scale = _scale(q, scale)
    if _device_kind(q, "flash_fwd") == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    q, k, v = _kernel_inputs("flash_fwd", q, k, v)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, D, _DTYPE_CODE[q.dtype], scale,
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(lib, err, "flash attention forward")
    _WRAPPERS["fwd"].launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=False, scale=None):
    """dq of ``flash_dq_kernel`` on CUDA tensors; ``flash_attention_dq_ref``
    on CPU tensors."""
    scale = _scale(q, scale)
    if _device_kind(q, "flash_bwd_dq") == "cpu":
        return flash_attention_dq_ref(q, k, v, dout, lse, delta, causal,
                                      scale)
    q, k, v, dout = _kernel_inputs("flash_bwd_dq", q, k, v, dout)
    B, S, H, D = q.shape
    lse = _stats(lse, B, H, S, q.device)
    delta = _stats(delta, B, H, S, q.device)
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, D,
        _DTYPE_CODE[q.dtype], scale, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(lib, err, "flash attention dq")
    _WRAPPERS["dq"].launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=False, scale=None):
    """(dk, dv) of ``flash_dkv_kernel`` on CUDA tensors;
    ``flash_attention_dkv_ref`` on CPU tensors."""
    scale = _scale(q, scale)
    if _device_kind(q, "flash_bwd_dkv") == "cpu":
        return flash_attention_dkv_ref(q, k, v, dout, lse, delta, causal,
                                       scale)
    q, k, v, dout = _kernel_inputs("flash_bwd_dkv", q, k, v, dout)
    B, S, H, D = q.shape
    lse = _stats(lse, B, H, S, q.device)
    delta = _stats(delta, B, H, S, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
        H, D, _DTYPE_CODE[q.dtype], scale, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(lib, err, "flash attention dk/dv")
    _WRAPPERS["dkv"].launches += 1
    return dk, dv


# Each wrapper counts its launches on itself; the counts are reached through
# this table so that they stay with the wrappers when a caller (a checking
# harness) rebinds the module's names around them.
_WRAPPERS = {"fwd": flash_fwd, "dq": flash_bwd_dq, "dkv": flash_bwd_dkv}
for _w in _WRAPPERS.values():
    _w.launches = 0


# --------------------------------------------------------------- autograd
class FlashAttentionFunction(torch.autograd.Function):
    """The custom VJP ``_flash`` (:439-455): q, k, v of one shape
    [B, S, H, D] (kv heads already repeated)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(out.dtype)
        delta = attention_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention over the paddle layout [B, S, H, D]; GQA by repeating
    each kv head ``H / Hkv`` times (``repeat_interleave``, as ``jnp.repeat``
    on axis 2). Differentiable through the flash backward."""
    if not supports(tuple(q.shape), tuple(k.shape)) or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        _scale(q, scale))
