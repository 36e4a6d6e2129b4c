"""Flash-attention forward (kernel K2).

Replaces the forward of the TPU kernel
``ctpa/ops/pallas/flash_attention.py:flash_attention``.  The CUDA kernel is
``ctpa_torch/csrc/flash_attention.cu`` (its header states the bound it
faces on the H100 and what its design does about it).  ``flash_attention``
launches it for CUDA tensors and takes the plain PyTorch version,
``flash_attention_plain``, only for CPU tensors.

Ported: bias in its three broadcast forms, non-causal, ``scale``,
``logit_bound`` (flat softmax), fp32 accumulation, bf16 and fp32 inputs.
``causal``, ``q_offset``, ``kv_mask`` and returning the logsumexp come with
the report-generation and training slices; until then they raise.
"""

from __future__ import annotations

import math

import torch

from ctpa_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64)


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


def flash_attention_plain(q, k, v, bias=None, scale: float | None = None,
                          logit_bound=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores and sums."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + (bias[None] if bias.ndim == 3 else bias).to(torch.float32)
    if logit_bound is None:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    else:
        p = torch.exp(s - torch.as_tensor(logit_bound, dtype=torch.float32, device=s.device))
    out = torch.matmul(p, v.to(torch.float32)) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)


def flash_attention(q, k, v, bias=None, causal: bool = False, scale: float | None = None,
                    kv_mask=None, q_offset=None, logit_bound=None,
                    return_lse: bool = False) -> torch.Tensor:
    """softmax(scale * q k^T + bias) v on (b, h, n, d) q and (b, h, m, d) k, v.

    ``logit_bound`` (a float or a scalar tensor) must bound every post-scale
    logit including the bias from above; it selects the flat softmax."""
    if causal or q_offset is not None:
        raise NotImplementedError("causal flash attention (and q_offset) is not ported yet")
    if kv_mask is not None:
        raise NotImplementedError("flash attention kv_mask is not ported yet")
    if return_lse:
        raise NotImplementedError("flash attention logsumexp output is not ported yet")
    _check(q, k, v, bias, logit_bound)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale, logit_bound)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, n, d = q.shape
    m = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    sb, sh = _bias_strides(bias, b, h, n, m) if bias is not None else (0, 0)
    bound = None
    if logit_bound is not None:
        bound = torch.as_tensor(logit_bound, dtype=torch.float32, device=q.device).reshape(1)
    out = torch.empty_like(q)
    lib = build.library().lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        bound.data_ptr() if bound is not None else None,
        out.data_ptr(), b, h, n, m, d, sb, sh, scale,
        int(q.dtype == torch.bfloat16), stream)
    build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
