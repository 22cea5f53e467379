"""Flash attention forward and backward, with and without a FlashMask —
the counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
(``_mha_fwd``, ``_mha_bwd``, ``_mha_bwd_chunked``, ``_allowed_mask``, the
custom VJPs ``_flash`` and ``_flash_masked``, and the wrappers
``flash_attention`` and ``flashmask_attention``).

Layouts follow the JAX package: q, k, v, out and the gradients are the
paddle layout ``[B, S, H, D]``; ``lse`` and ``delta`` are f32 ``[B * H, S]``.
The kernels read and write ``[B, S, H, D]`` directly, so the wrapper needs
no ``[B * H, S, D]`` transposes (JAX ``_to_bhsd``, :480-488).

* ``flash_attention`` — the wrapper: GQA by ``repeat_interleave`` of the kv
  heads (JAX ``jnp.repeat(kv, n_rep, axis=2)``, :491-494), then
  ``FlashAttentionFunction``, a ``torch.autograd.Function`` whose forward
  runs ``flash_fwd`` and saves ``(q, k, v, out, lse)``, and whose backward
  computes ``delta`` in f32 and runs ``flash_bwd_dq`` and ``flash_bwd_dkv``;
  a call that needs no gradient runs the forward alone. The forward goes
  through the operator ``torch.ops.paddle_tpu_torch.flash_fwd``
  (``flash_fwd_op``), which ``torch.export`` keeps in a program; the
  backward through ``flash_bwd_dq_op`` / ``flash_bwd_dkv_op``, so a step
  traced over fake CUDA tensors (``analysis``) holds the kernels as nodes.
* ``flashmask_attention`` — the same with a FlashMask: ``sri``
  (startend_row_indices) ``[B, H' in {1, H}, S, n <= 4]``, cast to int32
  and never broadcast to ``[B, H, S, n]``; ``FlashMaskFunction`` is its
  ``torch.autograd.Function`` (sri gets no gradient).
* ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv`` — one per kernel of
  ``csrc/flash_attention.cu``. On CUDA tensors each launches its kernel or
  raises (float32 / bfloat16 / float16, head_dim 64 or 128, any S); on CPU
  tensors each runs its plain version. With ``sri`` they run the masked form of
  their kernel; ``flashmask_fwd`` / ``flashmask_bwd_dq`` /
  ``flashmask_bwd_dkv`` are those calls under their own names. Each
  wrapper counts its kernel launches on ``.launches``: the masked launches
  on the ``flashmask_*`` wrappers, the others on the ``flash_*`` ones.
* ``flashmask_allowed`` — the mask ``_allowed_mask`` (:51-79) evaluates.
* ``flash_attention_fwd_ref`` / ``flash_attention_dq_ref`` /
  ``flash_attention_dkv_ref`` / ``flash_attention_bwd_ref`` — the plain
  PyTorch versions: the TPU kernels' arithmetic (``_fwd_kernel`` :89,
  ``_dq_kernel`` :166, ``_dkv_kernel`` :196) over whole rows, rounding where
  they round: P to V's dtype before P.V, p to dO's dtype before dV, ds to
  K's dtype before dq and to Q's before dk; f32 sums, one cast at the end.
  The backward is the explicit formulas, not autograd through a softmax.
  Each takes ``sri=None`` and then masks with ``flashmask_allowed``.
* ``kernel_tolerance`` — the elementwise limits a kernel output is held to
  against its plain version, derived from where the two round.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

__all__ = ["flash_attention", "FlashAttentionFunction", "supports",
           "KERNEL_HEAD_DIMS", "flash_fwd_op", "flash_bwd_dq_op",
           "flash_bwd_dkv_op",
           "flashmask_attention", "FlashMaskFunction", "flashmask_allowed",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flashmask_fwd",
           "flashmask_bwd_dq", "flashmask_bwd_dkv",
           "flash_attention_fwd_ref", "flash_attention_dq_ref",
           "flash_attention_dkv_ref", "flash_attention_bwd_ref",
           "attention_delta", "kernel_tolerance"]

_NEG = torch.finfo(torch.float32).min
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_HEAD_DIMS = (64, 128)      # the head dims the kernels take
# Limits of kernel_tolerance: twice the unit roundoff of the storage dtype
# (a value rounded on both sides, or a rounding that flips: bf16 keeps 8
# significant bits, f16 11), and the slack of f32 sums taken in another
# order (~256 ulps of the sum of |terms|). f16's range is narrow: below
# 2^-14 a rounded value keeps the absolute spacing 2^-24, so a rounded term
# may be off by 2^-25 on each side whatever its size (_TINY).
_ROUND2 = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
           torch.float32: 0.0}
_TINY = {torch.bfloat16: 0.0, torch.float16: 2.0 ** -24, torch.float32: 0.0}
_ACC = 2.0 ** -16


def supports(q_shape, k_shape) -> bool:
    """Static check: self-attention ``[B, S, H, D]`` with ``k_shape``'s kv
    heads dividing the query heads. The kernels further take head_dim 64 or
    128 and float32 / bfloat16 / float16, and raise on anything else."""
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


def flashmask_allowed(S, sri, causal):
    """[..., S, T] bool: query row r may attend key column c under the
    FlashMask ``sri`` [..., T, n] (``_allowed_mask`` :51-79, any integer
    dtype). Per column: causal n = 1 masks rows >= start, causal n >= 2
    rows in [start, end); non-causal reads [LTS, LTE, UTS, UTE] (LTE = S,
    UTS = UTE = 0 where fewer columns are given) and masks rows in
    [LTS, LTE) and in [UTS, UTE)."""
    T, n = sri.shape[-2], sri.shape[-1]
    rows = torch.arange(S, device=sri.device)[:, None]

    def col(j):
        return sri[..., j].unsqueeze(-2)                 # [..., 1, T]

    if causal:
        allowed = rows >= torch.arange(T, device=sri.device)[None, :]
        masked = rows >= col(0)
        if n > 1:
            masked = masked & (rows < col(1))
        return allowed & ~masked
    lower = (rows >= col(0)) & (rows < (col(1) if n > 1 else S))
    if n < 4:       # UTE = 0: the upper band is empty
        return ~lower
    return ~(lower | ((rows >= col(2)) & (rows < col(3))))


def _allowed(S, causal, device, sri=None):
    """[S, S] bool (or [B, H', S, S] under a FlashMask ``sri``): query row r
    may attend key column c."""
    if sri is not None:
        return flashmask_allowed(S, sri, causal)
    if not causal:
        return torch.ones((S, S), dtype=torch.bool, device=device)
    r = torch.arange(S, device=device)
    return r[:, None] >= r[None, :]


def _probs(q, k, lse, causal, scale, sri=None):
    """p = exp(s - lse) [B, H, S, S] f32, 0 where masked (TPU :182-187)."""
    s = _heads(q) @ _heads(k).mT * scale
    allowed = _allowed(q.shape[1], causal, q.device, sri)
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


def flash_attention_fwd_ref(q, k, v, causal=False, scale=None, sri=None):
    """(out [B, S, H, D] in q's dtype, lse [B * H, S] f32): the exact softmax
    of ``_fwd_kernel``: f32 scores, P = exp(s - m) rounded to V's dtype
    before P.V, f32 sums, o / l; 0 and 0 for a row with no allowed column.
    ``sri``: a FlashMask [B, H' in {1, H}, S, n] (``flashmask_allowed``)."""
    scale = _scale(q, scale)
    B, S, H, _ = q.shape
    s = _heads(q) @ _heads(k).mT * scale
    allowed = _allowed(S, causal, q.device, sri)
    s = torch.where(allowed, s, torch.full((), _NEG, device=q.device))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = e.to(v.dtype).float() @ _heads(v)
    live = allowed.any(-1, keepdim=True)                 # [.., S, 1]
    o = torch.where(live, o / l, torch.zeros((), device=q.device))
    lse = torch.where(live, m + torch.log(l), torch.zeros((), device=q.device))
    return _to_bshd(o, q.dtype), lse.reshape(B * H, S)


def flash_attention_dq_ref(q, k, v, dout, lse, delta, causal=False,
                           scale=None, sri=None):
    """dq = (p * (dO.V^T - delta) * scale, rounded to K's dtype) . K, in f32,
    cast once to q's dtype (``_dq_kernel``)."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale, sri)
    dp = _heads(dout) @ _heads(v).mT
    ds = p * (dp - delta.reshape(p.shape[:-1])[..., None]) * scale
    return _to_bshd(ds.to(k.dtype).float() @ _heads(k), q.dtype)


def flash_attention_dkv_ref(q, k, v, dout, lse, delta, causal=False,
                            scale=None, sri=None):
    """(dk, dv): dv = p^T . dO with p rounded to dO's dtype, dk = ds^T . Q
    with ds rounded to Q's dtype, f32 sums cast once (``_dkv_kernel``)."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale, sri)
    do = _heads(dout)
    dp = do @ _heads(v).mT
    ds = p * (dp - delta.reshape(p.shape[:-1])[..., None]) * scale
    dk = ds.to(q.dtype).float().mT @ _heads(q)
    dv = p.to(dout.dtype).float().mT @ do
    return _to_bshd(dk, k.dtype), _to_bshd(dv, v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False,
                            scale=None, sri=None):
    """(dq, dk, dv) of the plain backward, ``delta`` taken from out."""
    delta = attention_delta(out, dout)
    dq = flash_attention_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                                sri)
    dk, dv = flash_attention_dkv_ref(q, k, v, dout, lse, delta, causal,
                                     scale, sri)
    return dq, dk, dv


def kernel_tolerance(q, k, v, ref, causal=False, scale=None, dout=None,
                     delta=None, sri=None):
    """Elementwise limits on |kernel - plain| for every output named in
    ``ref`` ("out", "lse", "dq", "dk", "dv": the plain outputs for these
    inputs). ``ref["lse"]`` is always needed; the gradients need ``dout``
    and ``delta`` (or ``ref["out"]`` to take it from). Returns a dict with
    the keys of ``ref``.

    With p the normalised probabilities, smag = scale * max_c |q|.|k_c| the
    size of a row's scores (both over the allowed columns only, under a
    FlashMask ``sri`` too), r = 2^-7 for bf16, 2^-10 for f16 (0 for f32),
    and t = 2^-24 for f16 (0 otherwise):

    * out: r (|out| + sum_c p |v_c|) — each side rounds every probability
      (the kernel against its running max) and the output to bf16 — plus
      2^-16 (1 + smag) sum_c p |v_c| for f32 sums in another order, scores
      included;
    * lse: 2^-16 (1 + smag + |lse|), both sides in f32;
    * dq: r (|dq| + sum_c |ds| |k_c|) + 2^-16 sum_c dsmag |k_c|, where
      dsmag = p scale (|dO|.|v| + |delta| + |dp - delta| (1 + smag)) bounds
      ds and its f32 noise; dk likewise over the query rows with |q|; dv:
      r (|dv| + sum_r p |dO_r|) + 2^-16 sum_r p (1 + smag) |dO_r|;
    * f16 adds t (1 + sum_c |v_c|) to out (t (1 + sum_c |k_c|) to dq, over
      the rows |q| to dk and |dO| to dv): a rounded probability, ds or
      output below 2^-14 is off by up to 2^-25 on each side.
    """
    scale = _scale(q, scale)
    r, tiny = _ROUND2[q.dtype], _TINY[q.dtype]
    B, S, H, _ = q.shape
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    allowed = _allowed(S, causal, q.device, sri)
    live = allowed.float()
    smag = ((qf.abs() @ kf.abs().mT) * scale * allowed).amax(-1,
                                                             keepdim=True)
    lse = ref["lse"].reshape(B, H, S, 1)
    p = _probs(q, k, ref["lse"], causal, scale, sri)
    lim = {"lse": (_ACC * (1 + smag + lse.abs())).reshape(B * H, S)}
    if "out" in ref:
        mag = p @ vf.abs()
        lim["out"] = _to_bshd(r * (_heads(ref["out"]).abs() + mag)
                              + _ACC * (1 + smag) * mag
                              + tiny * (1 + live @ vf.abs()), torch.float32)
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
    terms = {"dq": lambda: (ds.abs(), dsmag, live, kf.abs()),
             "dk": lambda: (ds.abs().mT, dsmag.mT, live.mT, qf.abs()),
             "dv": lambda: (p.mT, (p * (1 + smag)).mT, live.mT, do.abs())}
    for name in grads:
        a, b, n, c = terms[name]()
        lim[name] = _to_bshd(r * (_heads(ref[name]).abs() + a @ c)
                             + _ACC * (b @ c) + tiny * (1 + n @ c),
                             torch.float32)
    return lim


# ---------------------------------------------------------------- kernels
def _kernel_inputs(what, *tensors):
    """Contiguous, 16-byte aligned copies where needed, after checking what
    the kernels take."""
    q = tensors[0]
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the kernel takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} unsupported by the kernel "
                         f"{KERNEL_HEAD_DIMS}")
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


def _check_sri(what, sri, q):
    """The FlashMask as the masked kernels read it: int32 [B, H', S, n],
    H' in {1, H}, 1 <= n <= 4, contiguous, on q's device."""
    B, S, H, _ = q.shape
    if sri.dtype != torch.int32:
        raise TypeError(f"{what}: sri must be int32 (the kernel reads int32), "
                        f"got {sri.dtype}")
    if (sri.dim() != 4 or sri.shape[0] != B or sri.shape[1] not in (1, H)
            or sri.shape[2] != S or not 1 <= sri.shape[3] <= 4):
        raise ValueError(f"{what}: sri must be [B, 1 or H, S, n <= 4] = "
                         f"[{B}, 1|{H}, {S}, 1..4], got {tuple(sri.shape)}")
    if sri.device != q.device:
        raise ValueError(f"{what}: sri on {sri.device}, q on {q.device}")
    if not sri.is_contiguous():
        raise ValueError(f"{what}: sri must be contiguous")


def _check_launch(lib, err, what):
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _device_kind(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {q.device}")
    return q.device.type


def _mask_args(sri):
    """(sri pointer or None, n, H') for the C entry points."""
    if sri is None:
        return None, 0, 0
    return sri.data_ptr(), sri.shape[3], sri.shape[1]


def flash_fwd(q, k, v, causal=False, scale=None, sri=None):
    """(out, lse) of the forward kernel (bf16 / f16:
    ``flash_fwd_wgmma_kernel``, f32: ``flash_fwd_f32_kernel``) on CUDA tensors (q, k, v of one
    shape [B, S, H, D]), its masked form under a FlashMask ``sri``;
    ``flash_attention_fwd_ref`` on CPU tensors."""
    scale = _scale(q, scale)
    if sri is not None:
        _check_sri("flash_fwd", sri, q)
    if _device_kind(q, "flash_fwd") == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale, sri)
    q, k, v = _kernel_inputs("flash_fwd", q, k, v)
    B, S, H, D = q.shape
    mask, n, hp = _mask_args(sri)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), mask, B, S, H, D, _DTYPE_CODE[q.dtype], scale,
        int(bool(causal)), n, hp,
        stream)
    _check_launch(lib, err, "flash attention forward")
    _build.count_launch(_WRAPPERS["fwd" if sri is None else "fm_fwd"],
                        stream)
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=False, scale=None,
                 sri=None):
    """dq of the dq kernel (bf16 / f16: ``flash_dq_wgmma_kernel``, f32:
    ``flash_dq_f32_kernel``) on CUDA tensors, its masked form under a
    FlashMask ``sri``; ``flash_attention_dq_ref`` on CPU tensors."""
    scale = _scale(q, scale)
    if sri is not None:
        _check_sri("flash_bwd_dq", sri, q)
    if _device_kind(q, "flash_bwd_dq") == "cpu":
        return flash_attention_dq_ref(q, k, v, dout, lse, delta, causal,
                                      scale, sri)
    q, k, v, dout = _kernel_inputs("flash_bwd_dq", q, k, v, dout)
    B, S, H, D = q.shape
    lse = _stats(lse, B, H, S, q.device)
    delta = _stats(delta, B, H, S, q.device)
    mask, n, hp = _mask_args(sri)
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), mask, B, S, H, D,
        _DTYPE_CODE[q.dtype], scale, int(bool(causal)), n, hp,
        stream)
    _check_launch(lib, err, "flash attention dq")
    _build.count_launch(_WRAPPERS["dq" if sri is None else "fm_dq"],
                        stream)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=False, scale=None,
                  sri=None):
    """(dk, dv) of the dk/dv kernel (bf16 / f16: ``flash_dkv_wgmma_kernel``,
    f32: ``flash_dkv_f32_kernel``) on CUDA tensors, its masked form under a
    FlashMask ``sri``; ``flash_attention_dkv_ref`` on CPU tensors."""
    scale = _scale(q, scale)
    if sri is not None:
        _check_sri("flash_bwd_dkv", sri, q)
    if _device_kind(q, "flash_bwd_dkv") == "cpu":
        return flash_attention_dkv_ref(q, k, v, dout, lse, delta, causal,
                                       scale, sri)
    q, k, v, dout = _kernel_inputs("flash_bwd_dkv", q, k, v, dout)
    B, S, H, D = q.shape
    lse = _stats(lse, B, H, S, q.device)
    delta = _stats(delta, B, H, S, q.device)
    mask, n, hp = _mask_args(sri)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), mask,
        B, S, H, D, _DTYPE_CODE[q.dtype], scale, int(bool(causal)), n, hp,
        stream)
    _check_launch(lib, err, "flash attention dk/dv")
    _build.count_launch(_WRAPPERS["dkv" if sri is None else "fm_dkv"],
                        stream)
    return dk, dv


def flashmask_fwd(q, k, v, sri, causal=False, scale=None):
    """``flash_fwd`` under the FlashMask ``sri``: the masked kernel."""
    return flash_fwd(q, k, v, causal, scale, sri=sri)


def flashmask_bwd_dq(q, k, v, dout, lse, delta, sri, causal=False,
                     scale=None):
    """``flash_bwd_dq`` under the FlashMask ``sri``: the masked kernel."""
    return flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, sri=sri)


def flashmask_bwd_dkv(q, k, v, dout, lse, delta, sri, causal=False,
                      scale=None):
    """``flash_bwd_dkv`` under the FlashMask ``sri``: the masked kernel."""
    return flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, sri=sri)


# Each wrapper counts its launches on itself; the counts are reached through
# this table so that they stay with the wrappers when a caller (a checking
# harness) rebinds the module's names around them.
_WRAPPERS = {"fwd": flash_fwd, "dq": flash_bwd_dq, "dkv": flash_bwd_dkv,
             "fm_fwd": flashmask_fwd, "fm_dq": flashmask_bwd_dq,
             "fm_dkv": flashmask_bwd_dkv}
for _w in _WRAPPERS.values():
    _w.launches = 0


# -------------------------------------------------------------- custom op
@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
           "-> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, causal, scale):
    """``flash_fwd`` as the operator ``torch.ops.paddle_tpu_torch.flash_fwd``:
    on CUDA tensors the kernel (its launch counted on ``flash_fwd``), on
    CPU tensors the plain version. A traced or exported program
    (``torch.export``, ``jit.save``) holds the operator, not one backend's
    body: its ``register_fake`` gives the shapes, and the call runs
    whichever form the tensors' device takes when the program runs."""
    return flash_fwd(q, k, v, causal, scale)


@flash_fwd_op.register_fake
def _flash_fwd_shapes(q, k, v, causal, scale):
    B, S, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B * H, S), dtype=torch.float32))


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, scale, *args,
                     **kwargs):
    """The operator's count for ``torch.utils.flop_counter`` (which does not
    look inside an operator): the plain version's two products over every
    (row, column) pair, 2 * 2 * B * H * S * S * D, on any device."""
    B, S, H, D = q_shape
    return 4 * B * H * S * S * D


@torch.library.custom_op(
    "paddle_tpu_torch::flash_bwd_dq", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
           "Tensor delta, bool causal, float scale) -> Tensor")
def flash_bwd_dq_op(q, k, v, dout, lse, delta, causal, scale):
    """``flash_bwd_dq`` as the operator
    ``torch.ops.paddle_tpu_torch.flash_bwd_dq`` (launch counted on
    ``flash_bwd_dq``), so that a program traced with fake tensors
    (``analysis``) holds the kernel as one node on any device."""
    return flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)


@flash_bwd_dq_op.register_fake
def _flash_bwd_dq_shapes(q, k, v, dout, lse, delta, causal, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_bwd_dkv", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
           "Tensor delta, bool causal, float scale) -> (Tensor, Tensor)")
def flash_bwd_dkv_op(q, k, v, dout, lse, delta, causal, scale):
    """``flash_bwd_dkv`` as the operator
    ``torch.ops.paddle_tpu_torch.flash_bwd_dkv``."""
    return flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)


@flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_shapes(q, k, v, dout, lse, delta, causal, scale):
    return (torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_bwd_dq)
def _flash_bwd_dq_flops(q_shape, *args, **kwargs):
    """The plain dq's three products (P, dP, dS.K): 6 * B * H * S * S * D."""
    B, S, H, D = q_shape
    return 6 * B * H * S * S * D


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_bwd_dkv)
def _flash_bwd_dkv_flops(q_shape, *args, **kwargs):
    """The plain dk / dv's four products (P, dP, dS^T.Q, P^T.dO):
    8 * B * H * S * S * D."""
    B, S, H, D = q_shape
    return 8 * B * H * S * S * D


# --------------------------------------------------------------- autograd
class FlashAttentionFunction(torch.autograd.Function):
    """The custom VJP ``_flash`` (:439-455): q, k, v of one shape
    [B, S, H, D] (kv heads already repeated); the forward is the operator
    ``flash_fwd_op``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd_op(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(out.dtype)
        delta = attention_delta(out, dout)
        dq = flash_bwd_dq_op(q, k, v, dout, lse, delta, ctx.causal,
                             ctx.scale)
        dk, dv = flash_bwd_dkv_op(q, k, v, dout, lse, delta, ctx.causal,
                                  ctx.scale)
        return dq, dk, dv, None, None


class FlashMaskFunction(torch.autograd.Function):
    """The custom VJP ``_flash_masked`` (:458-476): q, k, v of one shape
    [B, S, H, D] (kv heads already repeated), sri int32 [B, H', S, n]; sri
    gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, sri, causal, scale):
        out, lse = flashmask_fwd(q, k, v, sri, causal, scale)
        ctx.save_for_backward(q, k, v, sri, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, sri, out, lse = ctx.saved_tensors
        dout = dout.to(out.dtype)
        delta = attention_delta(out, dout)
        dq = flashmask_bwd_dq(q, k, v, dout, lse, delta, sri, ctx.causal,
                              ctx.scale)
        dk, dv = flashmask_bwd_dkv(q, k, v, dout, lse, delta, sri,
                                   ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _repeat_kv(q, k, v, what):
    if not supports(tuple(q.shape), tuple(k.shape)) or v.shape != k.shape:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    return k, v


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention over the paddle layout [B, S, H, D]; GQA by repeating
    each kv head ``H / Hkv`` times (``repeat_interleave``, as ``jnp.repeat``
    on axis 2). Differentiable through the flash backward."""
    k, v = _repeat_kv(q, k, v, "flash_attention")
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_fwd_op(q, k, v, bool(causal), _scale(q, scale))[0]
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        _scale(q, scale))


def flashmask_attention(q, k, v, sri, causal=False, scale=None):
    """FlashMask attention over [B, S, H, D] (JAX ``flashmask_attention``
    :537-557): GQA kv heads repeated as ``flash_attention`` repeats them;
    ``sri`` [B, H' in {1, H}, S, n <= 4] of any integer dtype, cast to int32
    on q's device and read per head by the kernels (H' = 1 is broadcast
    there, never materialised). Differentiable through the masked
    backward."""
    k, v = _repeat_kv(q, k, v, "flashmask_attention")
    sri = torch.as_tensor(sri).to(device=q.device,
                                  dtype=torch.int32).contiguous()
    _check_sri("flashmask_attention", sri, q)
    return FlashMaskFunction.apply(q, k, v, sri, bool(causal),
                                   _scale(q, scale))
