"""Single-token decode attention over the stacked KV cache (kernel K8).

Replaces the TPU kernel ``ctpa/ops/pallas/decode_attention.py:
decode_attention`` (``_kernel``).  The CUDA kernel is
``ctpa_torch/csrc/decode_attention.cu`` (its header states the bound it
faces on the H100 and what its design does about it).
``decode_attention`` launches it for CUDA tensors and takes the plain
PyTorch version, ``decode_attention_plain``, only for CPU tensors.

For query head ``g * rep + r`` (``rep = h / kvh``) and the valid slots m of
layer ``layer_idx``: ``s = (q . k_m) * k_scale_m * scale``, a softmax over
the valid slots in fp32, the weights times ``v_scale_m``, and ``out = sum_m
a_m v_m`` in q's dtype.  A row with no valid slot gives zeros.  The dots
take the cache values exactly (bf16 and int8 values are exact in fp32) and
sum in fp32.  ctpa's kernel rounds the softmax weights to the dot dtype
before the second product; the port keeps them in fp32, in both versions.

The kernel splits the slots of one (batch row, kv head) over a cluster of
``split_count(...)`` blocks, each owning the tiles ``rank_slots`` gives it;
rank 0 merges the blocks' softmax states in rank order.
"""

from __future__ import annotations

import functools

import torch

from ctpa_torch.kernels import build

_HEAD_DIMS = (16, 32, 64, 128)
_REPS = (1, 2, 4, 8)
# (q dtype, cache dtype) pairs the kernel takes, with its dtype code
_TYPES = {(torch.bfloat16, torch.bfloat16): 0, (torch.float32, torch.float32): 1,
          (torch.bfloat16, torch.int8): 2, (torch.float32, torch.int8): 3}

# launches of the CUDA kernel, under the name chip_smoke.py reports it by;
# the wrapper adds one where it launches, and nowhere else
LAUNCHES = {"decode_attention": 0}
# the grid (b * kvh * splits blocks) stays within this many blocks an SM, so
# that it runs in one wave: clusters of 4 or 8 at b 4 ran in two waves and
# were slower than clusters of 2 (profile_decode_attention.py on an H100)
BLOCKS_PER_SM = 2
SPLITS = (1, 2, 4, 8)


def tile_slots(hd: int) -> int:
    """Slots of one tile of the kernel's ring (csrc/decode_attention.cu:Geo::T)."""
    return 32 if hd == 128 else 64


def split_count(rows: int, m: int, hd: int, sms: int) -> int:
    """The blocks that share one (batch row, kv head), for ``rows`` = b * kvh
    such pairs on a card of ``sms`` SMs: the most in SPLITS that keep the
    grid within BLOCKS_PER_SM blocks an SM (1 if none does), and no more
    than the plane has tiles."""
    n_tiles = -(-m // tile_slots(hd))
    fit = [s for s in SPLITS if rows * s <= BLOCKS_PER_SM * sms and s <= n_tiles]
    return fit[-1] if fit else 1


def rank_slots(m: int, hd: int, splits: int) -> list[tuple[int, int]]:
    """The slots [start, stop) each rank of a cluster owns, as the kernel cuts
    them: rank r the tiles [r n / splits, (r + 1) n / splits) of the n =
    ceil(m / T), the last tile cut at m (an empty range where r n / splits
    meets (r + 1) n / splits)."""
    tile = tile_slots(hd)
    n_tiles = -(-m // tile)
    return [(min(r * n_tiles // splits * tile, m), min((r + 1) * n_tiles // splits * tile, m))
            for r in range(splits)]


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm_count(t: torch.Tensor) -> int:
    return _sms(t.device.index if t.device.index is not None else torch.cuda.current_device())


@functools.cache
def _sms(index: int) -> int:
    # cached: a decode step calls the wrapper 32 times and is host-bound
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, ck, cv, valid, layer_idx, k_scale, v_scale):
    if q.ndim != 3 or ck.ndim != 5 or ck.shape != cv.shape:
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(ck.shape)} {tuple(cv.shape)} must "
                         "be (b, h, hd) and two (L, b, kvh, m, hd)")
    b, h, hd = q.shape
    L, cb, kvh, m, chd = ck.shape
    if cb != b or chd != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(ck.shape)}")
    if valid.shape != (b, m) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool {(b, m)}, got {valid.dtype} {tuple(valid.shape)}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {L})")
    quant = ck.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache takes k_scale and v_scale, a float cache neither")
    tensors = [q, ck, cv, valid]
    if quant:
        for s in (k_scale, v_scale):
            if s.shape != ck.shape[:4] or s.dtype != torch.float32:
                raise ValueError(f"scales must be float32 {tuple(ck.shape[:4])}")
        tensors += [k_scale, v_scale]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")


def decode_attention_plain(q, ck, cv, valid, layer_idx: int, k_scale=None, v_scale=None,
                           scale: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 dots and softmax."""
    b, h, hd = q.shape
    kvh = ck.shape[2]
    k, v = ck[layer_idx].float(), cv[layer_idx].float()              # (b, kvh, m, hd)
    s = torch.einsum("bgrd,bgmd->bgrm", q.float().reshape(b, kvh, h // kvh, hd), k)
    if k_scale is not None:
        s = s * k_scale[layer_idx][:, :, None, :]
    keep = valid[:, None, None, :]
    s = torch.where(keep, s * scale, -1e30)
    e = torch.where(keep, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    a = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    if v_scale is not None:
        a = a * v_scale[layer_idx][:, :, None, :]
    return torch.einsum("bgrm,bgmd->bgrd", a, v).reshape(b, h, hd).to(q.dtype)


def kernel_limits(q, ck, cv, valid, k_scale, v_scale):
    """Raise for what the CUDA kernel does not take (the plain version takes
    any head dim, GQA ratio and dtype pair)."""
    b, h, hd = q.shape
    kvh = ck.shape[2]
    if (q.dtype, ck.dtype) not in _TYPES or cv.dtype != ck.dtype:
        raise TypeError(f"decode_attention kernel: q {q.dtype} with a {ck.dtype} cache is none "
                        f"of {list(_TYPES)}")
    if hd not in _HEAD_DIMS or h // kvh not in _REPS:
        raise ValueError(f"decode_attention kernel: head dim {hd} not in {_HEAD_DIMS} or "
                         f"GQA ratio {h // kvh} not in {_REPS}")
    tensors = [ck, cv, valid] + ([k_scale, v_scale] if k_scale is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the caches, valid and the scales must be contiguous (the kernel "
                         "reads the layer's planes in place)")
    if ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("the caches must be 16-byte aligned")


def decode_attention(q, ck, cv, valid, layer_idx: int, k_scale=None, v_scale=None,
                     scale: float = 1.0) -> torch.Tensor:
    """(b, h, hd) q attends layer ``layer_idx`` of the stacked head-major
    caches (L, b, kvh, m, hd) over the slots where ``valid`` (b, m) is True;
    int8 caches take their (L, b, kvh, m) fp32 ``k_scale`` and ``v_scale``.
    Returns (b, h, hd) in q's dtype."""
    _check(q, ck, cv, valid, layer_idx, k_scale, v_scale)
    if _device(q) == "cpu":
        return decode_attention_plain(q, ck, cv, valid, layer_idx, k_scale, v_scale, scale)
    kernel_limits(q, ck, cv, valid, k_scale, v_scale)
    L, b, kvh, m, hd = ck.shape
    q = q.contiguous()
    out = torch.empty_like(q)
    quant = k_scale is not None
    lib = build.library().lib
    rc = lib.decode_attention_launch(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), valid.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        out.data_ptr(), b, q.shape[1], kvh, m, hd, layer_idx, float(scale),
        _TYPES[(q.dtype, ck.dtype)], split_count(b * kvh, m, hd, _sm_count(q)), _stream(q))
    build.check_launch(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
