"""Flash attention: the forward (kernel K2) and the backward (kernel K3).

Replaces the TPU kernel ``ctpa/ops/pallas/flash_attention.py:flash_attention``
(forward, ``_flash_call``) and its custom-VJP backward (``_flash_bwd``).  The
CUDA kernels are ``ctpa_torch/csrc/flash_attention.cu`` (forward, optionally
with the row logsumexp) and ``ctpa_torch/csrc/flash_attention_bwd.cu`` (the
delta pre-pass, dQ, dK/dV and d(bias); every pass deterministic), bf16 on
the tensor cores by ``mma.sync`` for head dims 16, 32, 64 and 128, and
fp32 on the FMA units for head dims 16, 32 and 64; each file's header
states the bound it faces on the H100 and what its design does about it.  The
wrappers launch them for CUDA tensors and take the plain PyTorch versions
(``flash_attention_plain``, ``flash_attention_bwd_plain`` and one ``*_plain``
per backward pass) only for CPU tensors.

``flash_attention`` goes through a ``torch.autograd.Function`` whenever grad
mode is on and q, k, v or the bias requires grad: its forward launches the
logsumexp variant of K2 and its backward launches K3.  ``logit_bound`` and
the returned logsumexp carry no gradient (softmax is invariant to the
shift, as in ctpa).

Masks, as ctpa's: ``causal`` is top-left aligned (query i sees keys 0..i),
and ``q_offset`` (a scalar, used only with ``causal``) adds to every query
position, so query i sees keys 0..i + q_offset; ``kv_mask`` (b, m) marks the
real keys (> 0).  Masked cells take no part in the softmax.  A query row
with no valid key gets what ctpa's dense reference (``_dense_bwd`` and the
dense softmax over ``NEG_INF`` logits) gives it: the output is the mean of
v over all m keys, the logsumexp is ``NEG_INF``, and in the backward its
dq row and its share of dk are zero while each dv row gets 1/m of its dO
row (the uniform softmax weights; ds = 0 on masked cells).  ctpa's own
flash kernel differs there (its masked tiles are skipped or padded by
TPU lanes); the port follows the dense reference.  ``q_offset`` reaches the
kernels as a device scalar and is never read on the host.

On the card: head dims 16/32/64 in bf16 or fp32 with every form; head dim
128 in bf16 only, with every mask and bias form, but without d(bias) (a
bias that requires grad at head dim 128 raises there).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ctpa_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)
# ctpa's mask value; also the logsumexp of a query row with no valid key
NEG_INF = -1e30

# launches of each CUDA kernel, under the name chip_smoke.py reports it by;
# a wrapper adds one where it launches, and nowhere else.  The delta
# pre-pass serves every head dim.
LAUNCHES = dict.fromkeys(("flash_attention_fwd", "flash_attention_fwd_lse",
                          "flash_attention_bwd_delta", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv", "flash_attention_bwd_dbias",
                          "flash_attention_fwd_d128", "flash_attention_fwd_lse_d128",
                          "flash_attention_bwd_dq_d128", "flash_attention_bwd_dkv_d128"), 0)


class Masks(NamedTuple):
    """The mask arguments of one attention call.  ``kv_mask`` is a (b, m)
    bool tensor; ``q_offset`` an int32 scalar tensor on the inputs' device
    (it only acts with ``causal``)."""

    causal: bool = False
    kv_mask: Optional[torch.Tensor] = None
    q_offset: Optional[torch.Tensor] = None


NO_MASKS = Masks()


def _on(t: torch.Tensor, device) -> bool:
    want = torch.device(device)
    return t.device.type == want.type and want.index in (None, t.device.index)


def make_masks(causal: bool, kv_mask, q_offset, b: int, m: int, device) -> Masks:
    """Check and normalise the mask arguments: kv_mask to (b, m) bool,
    q_offset to an int32 scalar tensor on ``device`` (no host read)."""
    if kv_mask is not None:
        if not torch.is_tensor(kv_mask) or tuple(kv_mask.shape) != (b, m):
            shape = tuple(kv_mask.shape) if torch.is_tensor(kv_mask) else type(kv_mask)
            raise ValueError(f"kv_mask {shape} must be a ({b}, {m}) tensor")
        if not _on(kv_mask, device):
            raise ValueError("kv_mask must be on the inputs' device")
        kv_mask = (kv_mask if kv_mask.dtype == torch.bool else kv_mask > 0).contiguous()
    if q_offset is not None:
        if torch.is_tensor(q_offset):
            if q_offset.numel() != 1 or q_offset.is_floating_point() or q_offset.is_complex():
                raise ValueError(f"q_offset must be one integer, got {q_offset.dtype} "
                                 f"{tuple(q_offset.shape)}")
            if not _on(q_offset, device):
                raise ValueError("q_offset must be on the inputs' device")
            q_offset = q_offset.reshape(()).to(torch.int32)
        elif isinstance(q_offset, int) and not isinstance(q_offset, bool):
            q_offset = torch.tensor(q_offset, dtype=torch.int32, device=device)
        else:
            raise ValueError(f"q_offset must be an int or a one-element integer tensor, "
                             f"got {type(q_offset)}")
    return Masks(bool(causal), kv_mask, q_offset)


def _valid(masks: Masks, n: int, m: int, device):
    """(b or 1, 1, n, m) validity of each (query, key) cell, or None when
    every cell is valid."""
    valid = None
    if masks.causal:
        q_pos = torch.arange(n, device=device)[:, None]
        if masks.q_offset is not None:
            q_pos = q_pos + masks.q_offset
        valid = (torch.arange(m, device=device)[None, :] <= q_pos)[None, None]
    if masks.kv_mask is not None:
        kv = masks.kv_mask[:, None, None, :]
        valid = kv if valid is None else valid & kv
    return valid


def _bias_strides(bias, b, h, n, m):
    """Element strides (per batch item, per head) of a broadcast bias."""
    if bias.ndim == 4 and bias.shape == (b, h, n, m):
        return h * n * m, n * m
    if bias.ndim == 3 and bias.shape == (h, n, m):
        return 0, n * m
    if bias.ndim == 3 and bias.shape == (1, n, m):
        return 0, 0
    raise ValueError(f"bias {tuple(bias.shape)} is none of (h, n, m), (1, n, m), "
                     f"(b, h, n, m) for q/k of ({b}, {h}, {n}/{m})")


def _bias_items(bias, b, h):
    """(items, item_stride): how many of the b*h batch items share each slab
    of the bias, and the stride between them."""
    if bias.ndim == 4:
        return 1, 0
    if bias.shape[0] == 1:
        return b * h, 1
    return b, h


def _check(q, k, v, bias, logit_bound):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must be (b, h, n, d), (b, h, m, d), (b, h, m, d)")
    b, h, n, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}")
    tensors = [q, k, v]
    if bias is not None:
        _bias_strides(bias, b, h, n, k.shape[2])
        if bias.dtype != q.dtype:
            raise TypeError(f"bias dtype {bias.dtype} must match q's {q.dtype}")
        tensors.append(bias)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v and bias must be contiguous")
    if torch.is_tensor(logit_bound):
        tensors.append(logit_bound)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")


def _check_bwd(q, k, v, bias, lse, do, delta=None, out=None):
    """What the backward passes take: ``_check``'s inputs, dO (and O) like q,
    and the fp32 (b, h, n) lse (and delta), all contiguous on one device."""
    _check(q, k, v, bias, None)
    b, h, n, _ = q.shape
    for name, t in (("do", do), ("out", out)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match q "
                             f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != (b, h, n) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 {(b, h, n)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    rest = [t for t in (do, out, lse, delta) if t is not None]
    if not all(t.is_contiguous() for t in rest):
        raise ValueError("do, out, lse and delta must be contiguous")
    if len({q.device, *(t.device for t in rest)}) != 1:
        raise ValueError("all inputs must be on one device")


def _scores(q, k, bias, scale):
    """fp32 post-scale, post-bias logits (b, h, n, m)."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + (bias[None] if bias.ndim == 3 else bias).to(torch.float32)
    return s


def flash_attention_plain(q, k, v, bias=None, scale: float | None = None,
                          logit_bound=None, return_lse: bool = False, masks: Masks = NO_MASKS):
    """The forward kernel's function in plain PyTorch: fp32 scores and sums;
    with ``return_lse`` also the fp32 (b, h, n) row logsumexp.  ``masks``
    as ``make_masks`` returns them."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    s = _scores(q, k, bias, scale)
    valid = _valid(masks, q.shape[2], k.shape[2], q.device)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    if logit_bound is None:
        shift = s.amax(-1, keepdim=True)
    else:
        shift = torch.as_tensor(logit_bound, dtype=torch.float32, device=s.device)
    p = torch.exp(s - shift)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, v.to(torch.float32)) / denom
    lse = (shift + torch.log(denom)).squeeze(-1)
    if valid is not None:
        # a row with no valid key: ctpa's dense softmax is uniform over all m keys
        empty = ~valid.any(-1)
        out = torch.where(empty[..., None], v.to(torch.float32).mean(-2, keepdim=True), out)
        lse = torch.where(empty, NEG_INF, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def _sum_bias(ds, bias):
    """d(bias) from the fp32 (b, h, n, m) ds: summed over the batch items that
    broadcast the bias, in the bias dtype."""
    if bias.ndim == 3:
        ds = ds.sum(0)
        if bias.shape[0] == 1:
            ds = ds.sum(0, keepdim=True)
    return ds.to(bias.dtype)


def _probs_and_ds(q, k, v, bias, lse, delta, do, scale, masks):
    """The dense recompute: p = exp(s - lse) and ds = p (dO v^T - delta), fp32;
    both zero on masked cells, and p = 1/m on a row with no valid key."""
    p = torch.exp(_scores(q, k, bias, scale) - lse[..., None])
    dp = torch.matmul(do.to(torch.float32), v.to(torch.float32).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    valid = _valid(masks, q.shape[2], k.shape[2], q.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
        ds = torch.where(valid, ds, 0.0)
        p = torch.where(~valid.any(-1, keepdim=True), 1.0 / k.shape[2], p)
    return p, ds


def flash_attention_bwd_delta_plain(out, do):
    """delta = rowsum(dO * O), fp32 (b, h, n)."""
    return (do.to(torch.float32) * out.to(torch.float32)).sum(-1)


def flash_attention_bwd_dq_plain(q, k, v, bias, lse, delta, do, scale: float,
                                 masks: Masks = NO_MASKS):
    _, ds = _probs_and_ds(q, k, v, bias, lse, delta, do, scale, masks)
    return (torch.matmul(ds, k.to(torch.float32)) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, bias, lse, delta, do, scale: float,
                                  masks: Masks = NO_MASKS):
    p, ds = _probs_and_ds(q, k, v, bias, lse, delta, do, scale, masks)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(torch.float32)) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dbias_plain(q, k, v, bias, lse, delta, do, scale: float,
                                    masks: Masks = NO_MASKS):
    return _sum_bias(_probs_and_ds(q, k, v, bias, lse, delta, do, scale, masks)[1], bias)


def flash_attention_bwd_plain(q, k, v, bias, out, lse, do, scale: float,
                              masks: Masks = NO_MASKS):
    """The backward kernels' function in plain PyTorch, as the four passes
    compose it: (dq, dk, dv, dbias), dbias None without a bias; dbias is
    summed over the batch items that broadcast the bias and carries no
    scale."""
    delta = flash_attention_bwd_delta_plain(out, do)
    args = (q, k, v, bias, lse, delta, do, scale, masks)
    dk, dv = flash_attention_bwd_dkv_plain(*args)
    dbias = None if bias is None else flash_attention_bwd_dbias_plain(*args)
    return flash_attention_bwd_dq_plain(*args), dk, dv, dbias


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _card_check(q, tensors) -> None:
    """What the head-dim-128 kernels take beyond ``_check``: bf16, and rows
    on 16-byte boundaries (they copy 8 bf16 values at a time)."""
    if q.shape[-1] != 128:
        return
    if q.dtype != torch.bfloat16:
        raise TypeError("head dim 128 runs bf16 on the card (its kernels use bf16 tensor "
                        f"cores), got {q.dtype}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("head dim 128 on the card needs 16-byte aligned q, k, v, dO and O")


def _mask_args(masks: Masks):
    """(kv_mask pointer, q_offset pointer, causal) for a launcher."""
    kv = masks.kv_mask.data_ptr() if masks.kv_mask is not None else None
    qo = masks.q_offset.data_ptr() if masks.causal and masks.q_offset is not None else None
    return kv, qo, int(masks.causal)


def _kernel_name(base: str, d: int) -> str:
    return base + "_d128" if d == 128 else base


def _forward(q, k, v, bias, scale: float, bound, with_lse: bool, masks: Masks = NO_MASKS):
    """(out, lse or None) from the kernel on the card, the plain version on
    the CPU.  ``bound`` is None or a float32 scalar tensor on q's device."""
    if _device(q) == "cpu":
        res = flash_attention_plain(q, k, v, bias, scale, bound, return_lse=with_lse,
                                    masks=masks)
        return res if with_lse else (res, None)
    _card_check(q, (q, k, v))
    b, h, n, d = q.shape
    m = k.shape[2]
    sb, sh = _bias_strides(bias, b, h, n, m) if bias is not None else (0, 0)
    bound_ptr = bound.reshape(1).data_ptr() if bound is not None else None
    bias_ptr = bias.data_ptr() if bias is not None else None
    kv, qo, causal = _mask_args(masks)
    out = torch.empty_like(q)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bound_ptr, kv, qo, out.data_ptr())
    common = (b, h, n, m, d, sb, sh, causal, scale, int(q.dtype == torch.bfloat16), _stream(q))
    if not with_lse:
        _launch(_kernel_name("flash_attention_fwd", d), *ins, *common)
        return out, None
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch(_kernel_name("flash_attention_fwd_lse", d), *ins, lse.data_ptr(), *common)
    return out, lse


def _launch(name: str, *args) -> None:
    build.check_launch(getattr(build.library().lib, name + "_launch")(*args), name)
    LAUNCHES[name] += 1


def _bwd_args(q, k, bias, masks):
    """The inputs every backward launcher takes after q, k and v."""
    b, h, n, d = q.shape
    m = k.shape[2]
    sb, sh = _bias_strides(bias, b, h, n, m) if bias is not None else (0, 0)
    return b, h, n, m, d, sb, sh, (bias.data_ptr() if bias is not None else None), \
        *_mask_args(masks)


def flash_attention_bwd_delta(out, do) -> torch.Tensor:
    """delta = rowsum(dO * O), fp32 (b, h, n): the K3 pre-pass."""
    _check_bwd(out, out, out, None, None, do)
    if _device(out) == "cpu":
        return flash_attention_bwd_delta_plain(out, do)
    b, h, n, d = out.shape
    delta = torch.empty((b, h, n), dtype=torch.float32, device=out.device)
    _launch("flash_attention_bwd_delta", out.data_ptr(), do.data_ptr(), delta.data_ptr(),
            b, h, n, d, int(out.dtype == torch.bfloat16), _stream(out))
    return delta


def flash_attention_bwd_dq(q, k, v, bias, lse, delta, do, scale: float,
                           masks: Masks = NO_MASKS) -> torch.Tensor:
    """dQ (K3's dq pass)."""
    _check_bwd(q, k, v, bias, lse, do, delta=delta)
    if _device(q) == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, bias, lse, delta, do, scale, masks)
    _card_check(q, (q, k, v, do))
    b, h, n, m, d, sb, sh, bias_ptr, kv, qo, causal = _bwd_args(q, k, bias, masks)
    dq = torch.empty_like(q)
    _launch(_kernel_name("flash_attention_bwd_dq", d), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias_ptr, kv, qo, lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
            dq.data_ptr(), b, h, n, m, d, sb, sh, causal, scale,
            int(q.dtype == torch.bfloat16), _stream(q))
    return dq


def flash_attention_bwd_dkv(q, k, v, bias, lse, delta, do, scale: float,
                            masks: Masks = NO_MASKS):
    """(dK, dV) (K3's dk/dv pass)."""
    _check_bwd(q, k, v, bias, lse, do, delta=delta)
    if _device(q) == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, bias, lse, delta, do, scale, masks)
    _card_check(q, (q, k, v, do))
    b, h, n, m, d, sb, sh, bias_ptr, kv, qo, causal = _bwd_args(q, k, bias, masks)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_kernel_name("flash_attention_bwd_dkv", d), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias_ptr, kv, qo, lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, n, m, d, sb, sh, causal, scale,
            int(q.dtype == torch.bfloat16), _stream(q))
    return dk, dv


def flash_attention_bwd_dbias(q, k, v, bias, lse, delta, do, scale: float,
                              masks: Masks = NO_MASKS) -> torch.Tensor:
    """d(bias), summed over the batch items that broadcast it (K3's d(bias)
    pass; head dims 16-64 on the card)."""
    _check_bwd(q, k, v, bias, lse, do, delta=delta)
    if bias is None:
        raise ValueError("d(bias) needs a bias")
    if _device(q) == "cpu":
        return flash_attention_bwd_dbias_plain(q, k, v, bias, lse, delta, do, scale, masks)
    if q.shape[-1] == 128:
        raise NotImplementedError("d(bias) at head dim 128 has no kernel yet")
    b, h, n, m, d, _, _, bias_ptr, kv, qo, causal = _bwd_args(q, k, bias, masks)
    items, item_stride = _bias_items(bias, b, h)
    dbias = torch.empty_like(bias)
    _launch("flash_attention_bwd_dbias", q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            kv, qo, lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dbias.data_ptr(), b, h, n,
            m, d, items, item_stride, causal, scale, int(q.dtype == torch.bfloat16), _stream(q))
    return dbias


def flash_attention_bwd(q, k, v, bias, out, lse, do, scale: float, need_dbias: bool = True,
                        masks: Masks = NO_MASKS):
    """(dq, dk, dv, dbias) of ``flash_attention`` from its output ``out``, its
    fp32 row logsumexp ``lse`` (b, h, n) and the output gradient ``do``; on
    the card by the K3 kernels, on the CPU by the plain version.  dbias is
    None without a bias or when ``need_dbias`` is False."""
    _check_bwd(q, k, v, bias, lse, do, out=out)
    if _device(q) == "cpu":
        dq, dk, dv, dbias = flash_attention_bwd_plain(q, k, v, bias, out, lse, do, scale, masks)
        return dq, dk, dv, dbias if need_dbias else None
    delta = flash_attention_bwd_delta(out, do)
    args = (q, k, v, bias, lse, delta, do, scale, masks)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    dbias = flash_attention_bwd_dbias(*args) if bias is not None and need_dbias else None
    return dq, dk, dv, dbias


class _FlashAttentionFn(torch.autograd.Function):
    """Forward by K2 with the logsumexp, backward by K3."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, bound, masks):
        out, lse = _forward(q, k, v, bias, scale, bound, with_lse=True, masks=masks)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.masks = scale, masks
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias, out, lse, dout.contiguous(),
                                                ctx.scale, need_dbias=ctx.needs_input_grad[3],
                                                masks=ctx.masks)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, bias=None, causal: bool = False, scale: float | None = None,
                    kv_mask=None, q_offset=None, logit_bound=None, return_lse: bool = False):
    """softmax(scale * q k^T + bias) v on (b, h, n, d) q and (b, h, m, d) k, v;
    with ``return_lse`` the pair (out, fp32 (b, h, n) logsumexp of the logits).

    ``causal``, ``q_offset`` and ``kv_mask`` as in the module docstring.
    ``logit_bound`` (a float or a scalar tensor) must bound every post-scale
    logit including the bias from above; it selects the flat softmax."""
    _check(q, k, v, bias, logit_bound)
    masks = make_masks(causal, kv_mask, q_offset, q.shape[0], k.shape[2], q.device)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    bound = None
    if logit_bound is not None:
        bound = torch.as_tensor(logit_bound, dtype=torch.float32, device=q.device).detach()
    inputs = (q, k, v) if bias is None else (q, k, v, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        if bias is not None and bias.requires_grad and q.shape[-1] == 128 \
                and _device(q) == "cuda":
            raise NotImplementedError("d(bias) at head dim 128 has no kernel yet")
        out, lse = _FlashAttentionFn.apply(q, k, v, bias, scale, bound, masks)
    else:
        out, lse = _forward(q, k, v, bias, scale, bound, with_lse=return_lse, masks=masks)
    return (out, lse) if return_lse else out
