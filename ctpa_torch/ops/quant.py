"""Quantized serving weights (port of ``ctpa/ops/quant.py``): the host
quantizers (and the int4 KV cache's, ``quantize_kv_int4`` and
``unpack_kv_int4``), the int8 projection (kernel K4), the fused int8 SwiGLU FFN
(kernel K6), the int4 projection (kernel K5), the fused int4 SwiGLU FFN
(kernel K7), and ``quantize_tree`` on a ``state_dict``.

Layouts are ctpa's.  An int8 weight is ``kernel_q`` (in, out) int8 with a
per-output-channel ``scale`` (out,).  An int4 weight is ``kernel_q`` (in/2,
out) int8 with ``scale_g`` (in/group, out) fp32: byte j of group g holds row
g*G + j in its low nibble and row g*G + G/2 + j in its high nibble, signed
nibbles in [-7, 7].  Rounding is half-to-even (``torch.round``, as
``jnp.round``) on the quotient ``x / s``, so the packed bytes equal ctpa's
bit for bit.

K4 replaces ``ctpa/ops/quant.py:int8_matmul`` (``_q_kernel`` and, with
``act_quant``, ``_q_kernel_a8``), K6 ``int8_ffn`` (``_ffn_kernel``,
``_ffn_kernel_a8``), K5 ``int4_matmul`` (``_q4_kernel``, ``_q4_kernel_a8``)
and K7 ``int4_ffn`` (``_ffn_kernel_q4``, ``_ffn_kernel_q4_a8``).  The CUDA
kernels are ``ctpa_torch/csrc/int8_matmul.cu``, ``int8_ffn.cu``,
``int4_matmul.cu`` and ``int4_ffn.cu`` (their headers state the bounds they
face on the H100).  With ``impl="pallas"`` the wrappers launch them for CUDA
tensors and take the plain versions (``int8_matmul_plain``,
``int8_ffn_plain``, ``int4_matmul_plain``, ``int4_ffn_plain``), which compute
what the kernels compute, only for CPU tensors.  ``impl="xla"`` is ctpa's
explicit plain composition (its ``impl="xla"`` branches), on any device:

* w8 (weight-only int8): the int8 weight is exact in the activation dtype;
  fp32 sums, the per-column scale after them.  ctpa's kernel and its xla
  branch compute the same function, so ``impl="xla"`` is the plain version.
* w8a8 (``act_quant``): per-token int8 activations (``quantize_act_int8``),
  one exact int8 x int8 -> int32 dot, times the row scale, times the column
  scale.  The FFN kernel requantizes h = silu(g) u per row per j-block of
  ``INT8_BLOCK_J`` (256) columns and scales each j-block's exact down dot
  by its row scale; ctpa's xla composition (three int8 projections) rounds
  g, u and h to the activation dtype and requantizes h per full row.
* w4 (weight-only int4): the kernels round the dequantized weight to the
  activation dtype and sum in fp32; ctpa's xla branch dequantizes in fp32.
* w4a8 (``act_quant``): per-token int8 activations, one exact int8 x int8
  dot per scale group, scaled by the group's fp32 scale row and summed in
  fp32, times the row scale at the end.  The FFN kernel requantizes h per
  row per j-block of ``ffn_block_j`` columns (256 at Meditron-7B); ctpa's
  xla branch per full row.

Where torch has no integer matmul (the card), the int dots run as floating
products: int8 x int4 products and their sums over a group of at most 128
stay below 2^24, so they are exact in fp32 in any order; the int8 x int8
sums over a whole row (up to 11008 x 127^2, past 2^24) run in fp64, which
holds them exactly (``_int_dot``).
"""

from __future__ import annotations

import functools
import math

import torch

from ctpa_torch.kernels import build

GROUP = 128
_KERNEL_GROUPS = (32, 64, 128)
_BJ_MAX = 256

# launches of each CUDA kernel form, under the name chip_smoke.py reports it
# by (``kernel_name``: a form's decode kernel under its own name, its
# prefill kernel under "<form>_prefill"); a wrapper adds one where it
# launches, and nowhere else.  K4 and K5 launch once a call at any row
# count: a split contraction is added inside that launch, by the blocks of
# a thread-block cluster at decode and at prefill alike.  K6 and K7 launch
# twice at any row count (gate/up, then down; at decode each adds its own
# splits in its clusters, at prefill no kernel splits its contraction).
# Every int8-activation call (K4, K5, K6, K7) first quantizes x in one
# launch ("int4_act_quant")
_FORMS = ("int4_matmul", "int4_matmul_a8", "int4_ffn", "int4_ffn_a8", "int8_matmul",
          "int8_matmul_a8", "int8_ffn", "int8_ffn_a8")
LAUNCHES = dict.fromkeys((*_FORMS, *(f"{f}_prefill" for f in _FORMS), "int4_act_quant"), 0)
# K5 takes its weight-streaming kernel for at most this many rows (decode at
# batch 4 and 32) and its prefill kernel above; the streaming kernel's
# blocks own STREAM_COLUMNS output columns, and its contraction is split
# until the blocks fill what the card holds at once (its residency for the
# kernel's registers and shared memory, queried once per form), keeping at
# least STREAM_MIN_GROUPS scale groups a split
STREAM_MAX_ROWS = 32
STREAM_COLUMNS = 128
STREAM_MIN_GROUPS = 4
# K6's j-block (ctpa's int8_ffn block_j)
INT8_BLOCK_J = 256
# K6 at up to STREAM_MAX_ROWS rows: the gate/up kernel's blocks own one
# j-block and walk the hidden rows in ring stages of FFN_STREAM_KC, at least
# FFN_STREAM_MIN_STAGES a split; the down kernel's blocks own
# FFN_STREAM_COLUMNS output columns and walk whole j-blocks; the splits of
# a j-block or strip form one cluster of at most FFN_STREAM_MAX_SPLITS.  K7
# at decode does the same with whole scale groups (at least
# STREAM_MIN_GROUPS a gate/up split) and its ffn_block_j j-blocks, and K4
# with STREAM_COLUMNS-column strips over ring stages of INT8_STREAM_KC
# contraction rows, at least FFN_STREAM_MIN_STAGES a split
FFN_STREAM_KC = 32
FFN_STREAM_MIN_STAGES = 4
FFN_STREAM_COLUMNS = 128
FFN_STREAM_MAX_SPLITS = 8
INT8_STREAM_KC = 64
# K6 and K7 above STREAM_MAX_ROWS rows: the down kernel's blocks own
# PREFILL_COLUMNS output columns (the gate/up kernel's one j-block).  K4 and
# K5 above STREAM_MAX_ROWS rows: the prefill kernel's blocks own
# PREFILL_COLUMNS output columns and PREFILL_TOKENS tokens
# (PREFILL_TOKENS_W4A8 for w4a8); where those blocks are fewer than the
# card runs at once, the contraction is split in chunks of PREFILL_KC rows,
# at least PREFILL_MIN_CHUNKS a split, across a cluster of at most
# FFN_STREAM_MAX_SPLITS blocks
PREFILL_COLUMNS = 256
PREFILL_TOKENS = 128
PREFILL_TOKENS_W4A8 = 64
PREFILL_KC = 128
PREFILL_MIN_CHUNKS = 4


def kernel_name(form: str, m: int) -> str:
    """The ``LAUNCHES`` key of a K4-K7 form's kernel on m rows: the decode
    kernel's up to STREAM_MAX_ROWS rows, else the prefill kernel's."""
    return form if m <= STREAM_MAX_ROWS else f"{form}_prefill"


# ------------------------------------------------------------------ host side

def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float weights -> (int8 (in, out), fp32 per-column scale (out,))."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(0) / 127.0, min=1e-12)
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def dequantize_int8(w8: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (w8.float() * scale).to(dtype)


def _int4_group(d_in: int, group: int) -> int:
    """Largest group <= ``group`` that divides d_in (halving), as ctpa's."""
    g = min(group, d_in)
    while g > 2 and d_in % g != 0:
        g //= 2
    if d_in % g or g % 2:
        raise ValueError(f"no even int4 group divides {d_in} (group {group})")
    return g


def quantize_int4(w: torch.Tensor, group: int = GROUP) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float weights -> (packed int8 (in/2, out), fp32 group scales
    (in/group, out)): symmetric absmax per (input group, output column),
    values in [-7, 7], the two halves of each group paired in a byte."""
    d_in, d_out = w.shape
    g = _int4_group(d_in, group)
    wf = w.float().reshape(d_in // g, g, d_out)
    s = torch.clamp(wf.abs().amax(1) / 7.0, min=1e-12)
    q = torch.clamp(torch.round(wf / s[:, None, :]), -7, 7).to(torch.int32)
    lo, hi = q[:, : g // 2], q[:, g // 2:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    return packed.reshape(d_in // 2, d_out), s


def _unpack_int4(packed: torch.Tensor, group: int) -> torch.Tensor:
    """(in/2, out) packed -> (n_groups, group, out) int8 in natural row order."""
    p = packed.reshape(-1, group // 2, packed.shape[-1]).to(torch.int32)   # sign-extended
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28)
    hi = torch.bitwise_right_shift(p, 4)
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, group: int = GROUP,
                    dtype=torch.bfloat16) -> torch.Tensor:
    d_in = packed.shape[0] * 2
    g = _int4_group(d_in, group)
    w = _unpack_int4(packed, g).float() * scale[:, None, :]
    return w.reshape(d_in, -1).to(dtype)


def quantize_kv_int4(rows: torch.Tensor, group: int = 32,
                     scale_dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """KV-cache rows (..., hd) -> (packed int8 (..., hd/2), group scales
    (..., hd/group) in ``scale_dtype``): symmetric absmax per contiguous
    group of head_dim, values in [-7, 7].  Byte j of group g holds elements
    g*gs + j (low nibble) and g*gs + gs/2 + j (high nibble), so
    ``unpack_kv_int4`` restores natural order.  A bf16 scale is rounded
    first and the nibbles quantized against the rounded value, so the
    attention's fold of the scales stays exact."""
    hd = rows.shape[-1]
    gs = _int4_group(hd, group)
    rf = rows.float().reshape(*rows.shape[:-1], hd // gs, gs)
    s = torch.clamp(rf.abs().amax(-1) / 7.0, min=1e-12).to(scale_dtype)
    q = torch.clamp(torch.round(rf / s[..., None].float()), -7, 7).to(torch.int32)
    lo, hi = q[..., : gs // 2], q[..., gs // 2:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    return packed.reshape(*rows.shape[:-1], hd // 2), s


def unpack_kv_int4(packed: torch.Tensor, group: int) -> torch.Tensor:
    """(..., hd/2) packed -> (..., hd/group, group) int8, natural order inside
    each group (the inverse of ``quantize_kv_int4``'s pairing)."""
    hd = packed.shape[-1] * 2
    gs = _int4_group(hd, group)
    p = packed.reshape(*packed.shape[:-1], hd // gs, gs // 2).to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28)
    hi = torch.bitwise_right_shift(p, 4)
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_act_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (..., in) -> (int8 (..., in), fp32 (..., 1))."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(-1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def _rup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def ffn_block_j(inter: int, group_i: int) -> int:
    """The FFN's j-block width, ctpa's rule (``int4_ffn`` at its block_j of
    256): whole down-scale groups, at most 256, or the whole padded width
    when a partial block would not be a multiple of 128.  It fixes the
    columns each w4a8 requantization of h takes its row scale over."""
    block_j = max(group_i, (min(_BJ_MAX, _rup(inter, group_i)) // group_i) * group_i)
    j_pad = _rup(inter, block_j)
    if j_pad != block_j and block_j % 128 != 0:
        block_j = j_pad
    return block_j


def _group_dot(x8: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor, group: int):
    """sum_g (x8_g . q_g) * scale_g over the scale groups, in group order:
    (m, in) int8 against packed (in/2, out) -> (m, out) fp32."""
    q = _unpack_int4(w4, group).float()
    acc = torch.zeros(x8.shape[0], w4.shape[1], device=x8.device)
    for gi in range(q.shape[0]):
        part = x8[:, gi * group:(gi + 1) * group].float() @ q[gi]
        acc = acc + part * scale[gi]
    return acc


def cluster_splits(clusters: tuple, cap: int, units: int) -> int:
    """The most splits s, up to ``cap`` and FFN_STREAM_MAX_SPLITS, with which
    ``units`` clusters of s blocks all run at once on the card
    (``clusters[s - 1]`` is how many it runs at once), else 1."""
    return max([s for s in range(1, min(cap, FFN_STREAM_MAX_SPLITS) + 1)
                if clusters[s - 1] >= units] or [1])


def _cluster_occupancy(key: tuple, query, kernels: int) -> tuple:
    """How many clusters of 1 to FFN_STREAM_MAX_SPLITS blocks of each of a
    form's ``kernels`` decode kernels the card runs at once: ``query(k,
    splits)``, asked once per ``key``; raises if a query fails."""
    if key not in _RESIDENCY:
        clusters = tuple(tuple(query(k, s) for s in range(1, FFN_STREAM_MAX_SPLITS + 1))
                         for k in range(kernels))
        if min(min(c) for c in clusters) < 0:
            raise RuntimeError(f"{key[0]}_stream: cluster occupancy query failed ({clusters})")
        _RESIDENCY[key] = clusters
    return _RESIDENCY[key]


def _row_tier(m: int) -> int:
    """The decode kernels' token tiles of 8 rows: 1, 2 or 4."""
    return 1 if m <= 8 else 2 if m <= 16 else 4


# ------------------------------------------------------------------ K5

def _check_matmul(x, w4, scale, group):
    if w4.dtype != torch.int8 or w4.ndim != 2 or scale.ndim != 2:
        raise ValueError(f"w4 must be packed int8 (in/2, out), got {w4.dtype} {tuple(w4.shape)}")
    d_in = x.shape[-1]
    if w4.shape[0] * 2 != d_in:
        raise ValueError(f"x's last dim {d_in} does not match packed w4 {tuple(w4.shape)}")
    g = _int4_group(d_in, group)
    if tuple(scale.shape) != (d_in // g, w4.shape[1]) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be fp32 {(d_in // g, w4.shape[1])}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if len({x.device, w4.device, scale.device}) != 1:
        raise ValueError("all inputs must be on one device")
    return g


def int4_matmul_plain(x, w4, scale, group: int = GROUP, act_quant: bool = False):
    """The kernel's function in plain PyTorch: w4 dequantizes in fp32 and rounds
    to x's dtype, then fp32 sums; w4a8 as the module docstring says."""
    *lead, d_in = x.shape
    g = _int4_group(d_in, group)
    xm = x.reshape(-1, d_in)
    if act_quant:
        x8, sx = quantize_act_int8(xm)
        y = _group_dot(x8, w4, scale, g) * sx
    else:
        w = dequantize_int4(w4, scale, g, torch.float32).to(x.dtype)
        y = xm.float() @ w.float()
    return y.to(x.dtype).reshape(*lead, w4.shape[1])


def _int4_matmul_xla(x, w4, scale, group: int, act_quant: bool):
    """ctpa's impl="xla" branch: the exact w4a8 einsum, or an fp32
    dequantized product for weight-only."""
    *lead, d_in = x.shape
    if act_quant:
        x8, sx = quantize_act_int8(x)
        q = _unpack_int4(w4, group).float()                          # (n_g, G, out)
        xg = x8.reshape(-1, d_in // group, group).float()
        part = torch.einsum("mng,ngo->nmo", xg, q)                   # exact integers
        y = (part * scale[:, None, :]).sum(0) * sx.reshape(-1, 1)
        return y.to(x.dtype).reshape(*lead, w4.shape[1])
    w = dequantize_int4(w4, scale, group, torch.float32)
    return (x.float() @ w).to(x.dtype)


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
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and on a 16-byte boundary (the kernels load 16 bytes at once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bf16_only(x, kind: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kind} kernels take bf16 activations, got {x.dtype}")


def _kernel_limits(x, g: int) -> None:
    if g not in _KERNEL_GROUPS:
        raise ValueError(f"int4 kernels: scale group {g} not in {_KERNEL_GROUPS}")
    _bf16_only(x, "int4")


def prefill_plan(m: int, d_in: int, d_out: int, clusters: tuple,
                 tokens: int = PREFILL_TOKENS) -> tuple[str, int, int, int, int]:
    """("wgmma", token tiles, column strips, splits, PREFILL_KC-row chunks per
    split) of K4's or K5's prefill kernel on m rows: a block a tile of
    ``tokens`` rows and a PREFILL_COLUMNS-column strip; where those blocks
    are fewer than the card runs at once, the most splits (up to
    FFN_STREAM_MAX_SPLITS, at least PREFILL_MIN_CHUNKS chunks each) with
    which every block's cluster runs at once (``clusters[s - 1]``: how many
    clusters of s blocks of the kernel the card runs at once)."""
    tiles, strips = math.ceil(m / tokens), math.ceil(d_out / PREFILL_COLUMNS)
    chunks = math.ceil(d_in / PREFILL_KC)
    splits = cluster_splits(clusters, chunks // PREFILL_MIN_CHUNKS, tiles * strips)
    per = math.ceil(chunks / splits)
    return "wgmma", tiles, strips, math.ceil(chunks / per), per


def stream_splits(d_in: int, d_out: int, group: int, blocks: int) -> tuple[int, int]:
    """(splits, scale groups per split) of the decode kernel: as many blocks
    as the card holds at once (``blocks``), in whole splits of at least
    STREAM_MIN_GROUPS groups, when its column strips alone are fewer."""
    strips = math.ceil(d_out / STREAM_COLUMNS)
    n_g = d_in // group
    splits = max(1, min(n_g // STREAM_MIN_GROUPS, blocks // strips))
    per = math.ceil(n_g / splits)
    return math.ceil(n_g / per), per


def int4_matmul_plan(m: int, d_in: int, d_out: int, group: int, occupancy: tuple,
                     act_quant: bool = False) -> tuple:
    """The kernel of a K5 call on m rows, one launch either way: ("stream",
    splits, scale groups per split) up to STREAM_MAX_ROWS rows, the
    weight-streaming kernel adding its splits itself; else
    ``prefill_plan``'s ("wgmma", token tiles, strips, splits, chunks per
    split) on the prefill kernel's token tile (w4a8's is smaller).
    ``occupancy``: the chosen kernel's, ``occupancy[s - 1]`` clusters of s
    blocks the card runs at once (the decode kernel forms no clusters: only
    ``occupancy[0]``, its blocks at once, is read)."""
    if m <= STREAM_MAX_ROWS:
        return ("stream", *stream_splits(d_in, d_out, group, occupancy[0]))
    return prefill_plan(m, d_in, d_out, occupancy,
                        PREFILL_TOKENS_W4A8 if act_quant else PREFILL_TOKENS)


_RESIDENCY: dict = {}


def _stream_residency(x: torch.Tensor, m: int, group: int, act_quant: bool) -> int:
    """Blocks of the decode kernel the card holds on one SM (its occupancy,
    queried once per row tier, group and form)."""
    key = (x.device, _row_tier(m), group, act_quant)
    if key not in _RESIDENCY:
        blocks = build.library().lib.int4_matmul_stream_residency(m, group, int(act_quant))
        if blocks < 1:
            raise RuntimeError(f"int4_matmul_stream: occupancy query failed ({blocks})")
        _RESIDENCY[key] = blocks
    return _RESIDENCY[key]


def int4_matmul_launches(m: int, act_quant: bool) -> dict:
    """The launches of one K5 call on m rows, under ``LAUNCHES``' names: its
    kernel once (``kernel_name``), and the activation quantization for
    w4a8."""
    return {kernel_name("int4_matmul_a8" if act_quant else "int4_matmul", m): 1,
            "int4_act_quant": int(act_quant)}


# the decode kernel's per-strip counters, zero between calls (each call
# leaves them zero), and its split partials: one buffer each per device,
# grown as needed, shared by calls that run one after another on a stream
_COUNTERS: dict = {}
_PARTIALS: dict = {}


def _strip_counters(device, strips: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < strips:
        buf = torch.zeros(max(strips, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _stream_partials(device, numel: int) -> torch.Tensor:
    buf = _PARTIALS.get(device)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, device=device)
        _PARTIALS[device] = buf
    return buf


def int4_matmul_plan_on(xm: torch.Tensor, d_out: int, group: int, act_quant: bool) -> tuple:
    """``int4_matmul_plan`` of a K5 call on the (m, in) rows xm on its card
    (the decode kernel's residency on every SM, or the prefill kernel's
    cluster occupancy, queried once per form)."""
    m, d_in = xm.shape
    if m <= STREAM_MAX_ROWS:
        occupancy = (_sm_count(xm) * _stream_residency(xm, m, group, act_quant),)
    else:
        lib = build.library().lib
        occupancy = _cluster_occupancy(
            ("int4_matmul_prefill", xm.device, group, act_quant),
            lambda _, s: lib.int4_matmul_prefill_clusters(group, int(act_quant), s), 1)[0]
    return int4_matmul_plan(m, d_in, d_out, group, occupancy, act_quant)


def _quantize_act_kernel(xm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_act_int8`` of contiguous bf16 (m, k) x in one launch, bit
    for bit: int8 (m, k) and the fp32 row scales (m,)."""
    m, d_in = xm.shape
    x8 = torch.empty(m, d_in, dtype=torch.int8, device=xm.device)
    sx = torch.empty(m, dtype=torch.float32, device=xm.device)
    rc = build.library().lib.int4_act_quant_launch(xm.data_ptr(), x8.data_ptr(), sx.data_ptr(),
                                                   m, d_in, _stream(xm))
    build.check_launch(rc, "int4_act_quant")
    LAUNCHES["int4_act_quant"] += 1
    return x8, sx


def _int4_matmul_kernel(x, w4, scale, g: int, act_quant: bool):
    *lead, d_in = x.shape
    d_out = w4.shape[1]
    _kernel_limits(x, g)
    xm = _aligned(x.reshape(-1, d_in))
    m = xm.shape[0]
    w4, scale = _aligned(w4), _aligned(scale)
    sx = None
    if act_quant:
        xm, sx = _quantize_act_kernel(xm)
    out = torch.empty(m, d_out, dtype=x.dtype, device=x.device)
    kernel, *_, splits, per = int4_matmul_plan_on(xm, d_out, g, act_quant)
    ptrs = (xm.data_ptr(), sx.data_ptr() if act_quant else None, w4.data_ptr(),
            scale.data_ptr(), out.data_ptr())
    lib = build.library().lib
    if kernel == "stream":
        work = counters = None
        if splits > 1:
            work = _stream_partials(x.device, splits * m * d_out).data_ptr()
            counters = _strip_counters(x.device, math.ceil(d_out / STREAM_COLUMNS)).data_ptr()
        rc = lib.int4_matmul_stream_launch(*ptrs, work, counters, m, d_in, d_out, g, per, splits,
                                           int(act_quant), _stream(x))
    else:
        rc = lib.int4_matmul_prefill_launch(*ptrs, m, d_in, d_out, g, per, splits,
                                            int(act_quant), _stream(x))
    name = kernel_name("int4_matmul_a8" if act_quant else "int4_matmul", m)
    build.check_launch(rc, name)
    LAUNCHES[name] += 1
    return out.reshape(*lead, d_out)


def int4_matmul(x, w4, scale, group: int = GROUP, impl: str = "pallas",
                act_quant: bool = False) -> torch.Tensor:
    """(..., in) x against packed int4 (in/2, out) weights with (in/group, out)
    fp32 group scales -> (..., out) in x's dtype.  ``act_quant`` is w4a8."""
    g = _check_matmul(x, w4, scale, group)
    if impl == "xla":
        return _int4_matmul_xla(x, w4, scale, g, act_quant)
    if impl != "pallas":
        raise ValueError(f"unknown impl {impl!r}")
    if _device(x) == "cpu":
        return int4_matmul_plain(x, w4, scale, g, act_quant)
    return _int4_matmul_kernel(x, w4, scale, g, act_quant)


# ------------------------------------------------------------------ K7

def _check_ffn(x, wg4, sg, wu4, su, wd4, sd, group):
    hidden, inter = x.shape[-1], sg.shape[1]
    g_h, g_i = _int4_group(hidden, group), _int4_group(inter, group)
    shapes = {"wg4": (wg4, (hidden // 2, inter), torch.int8),
              "wu4": (wu4, (hidden // 2, inter), torch.int8),
              "wd4": (wd4, (inter // 2, hidden), torch.int8),
              "sg": (sg, (hidden // g_h, inter), torch.float32),
              "su": (su, (hidden // g_h, inter), torch.float32),
              "sd": (sd, (inter // g_i, hidden), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    return g_h, g_i


def int4_ffn_plain(x, wg4, sg, wu4, su, wd4, sd, group: int = GROUP,
                   act_quant: bool = False):
    """The kernel's function in plain PyTorch: down(silu(x Wg) * (x Wu)).  w4:
    weights rounded to x's dtype, g and u fp32, h rounded to x's dtype; w4a8:
    h requantized per row per ``ffn_block_j`` columns, the down product per
    scale group and j-block, scaled, summed over the j-blocks in order."""
    *lead, hidden = x.shape
    inter = sg.shape[1]
    g_h, g_i = _int4_group(hidden, group), _int4_group(inter, group)
    dt = x.dtype
    xm = x.reshape(-1, hidden)
    if not act_quant:
        wg, wu, wd = (dequantize_int4(w, s, gg, torch.float32).to(dt).float()
                      for w, s, gg in ((wg4, sg, g_h), (wu4, su, g_h), (wd4, sd, g_i)))
        xf = xm.float()
        g, u = xf @ wg, xf @ wu
        h = (g * torch.sigmoid(g) * u).to(dt)
        return (h.float() @ wd).to(dt).reshape(*lead, hidden)
    x8, sx = quantize_act_int8(xm)
    g = _group_dot(x8, wg4, sg, g_h) * sx
    u = _group_dot(x8, wu4, su, g_h) * sx
    h = g * torch.sigmoid(g) * u
    bj = ffn_block_j(inter, g_i)
    n_j = _rup(inter, bj) // bj
    qd = _unpack_int4(wd4, g_i).float()                               # (inter/g_i, g_i, hidden)
    acc = torch.zeros(xm.shape[0], hidden, device=x.device)
    for j in range(n_j):
        hj = h[:, j * bj:(j + 1) * bj]                                # the pad columns are 0
        sh = torch.clamp(hj.abs().amax(-1, keepdim=True) / 127.0, min=1e-12)
        h8 = torch.clamp(torch.round(hj / sh), -127, 127)
        down = torch.zeros_like(acc)
        for gj in range(hj.shape[1] // g_i):
            gi = j * bj // g_i + gj
            part = h8[:, gj * g_i:(gj + 1) * g_i] @ qd[gi]
            down = down + part * sd[gi]
        acc = acc + down * sh
    return acc.to(dt).reshape(*lead, hidden)


def _int4_ffn_xla(x, wg4, sg, wu4, su, wd4, sd, g_h: int, g_i: int, act_quant: bool):
    """ctpa's impl="xla" branch: the w4a8 matmul composition (h requantized
    per full row), or fp32 dequantized products."""
    if act_quant:
        g = _int4_matmul_xla(x, wg4, sg, g_h, True)
        u = _int4_matmul_xla(x, wu4, su, g_h, True)
        h = (torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype)
        return _int4_matmul_xla(h, wd4, sd, g_i, True)
    xf = x.float()
    h = (torch.nn.functional.silu(xf @ dequantize_int4(wg4, sg, g_h, torch.float32))
         * (xf @ dequantize_int4(wu4, su, g_h, torch.float32)))
    return (h @ dequantize_int4(wd4, sd, g_i, torch.float32)).to(x.dtype)


def int4_ffn_stream_splits(hidden: int, inter: int, group: int,
                           clusters: tuple) -> tuple[int, int, int, int]:
    """(gate/up splits, scale groups per split, down splits, j-blocks per
    split) of K7's decode kernels: ``int8_ffn_stream_splits``' rule over
    whole hidden scale groups (at least STREAM_MIN_GROUPS a split) and
    ``ffn_block_j``'s j-blocks; ``clusters[k][s - 1]`` is how many clusters of
    s blocks kernel k (0 gate/up, 1 down) runs at once on the card."""
    g_h, g_i = _int4_group(hidden, group), _int4_group(inter, group)
    bj = ffn_block_j(inter, g_i)
    n_j = _rup(inter, bj) // bj
    groups = hidden // g_h
    gu = cluster_splits(clusters[0], groups // STREAM_MIN_GROUPS, n_j)
    gu_per = math.ceil(groups / gu)
    dn = cluster_splits(clusters[1], n_j, math.ceil(hidden / FFN_STREAM_COLUMNS))
    dn_per = math.ceil(n_j / dn)
    return math.ceil(groups / gu_per), gu_per, math.ceil(n_j / dn_per), dn_per


def int4_ffn_plan(m: int, hidden: int, inter: int, group: int, clusters: tuple) -> tuple:
    """The kernels of a K7 call on m rows: ("stream", gate/up splits, groups
    per split, down splits, j-blocks per split) up to STREAM_MAX_ROWS rows
    (``clusters`` as ``int4_ffn_stream_splits`` takes it), else ("wgmma",
    j-blocks, output strips): the prefill kernels, gate/up over one block
    column a j-block, down over one a PREFILL_COLUMNS-column strip."""
    if m <= STREAM_MAX_ROWS:
        return ("stream", *int4_ffn_stream_splits(hidden, inter, group, clusters))
    bj = ffn_block_j(inter, _int4_group(inter, group))
    return ("wgmma", _rup(inter, bj) // bj, math.ceil(hidden / PREFILL_COLUMNS))


def int4_ffn_launches(m: int, hidden: int, inter: int, group: int, act_quant: bool) -> dict:
    """The launches of one K7 call on m rows, under ``LAUNCHES``' names: two
    (gate/up, down) at any row count, of its decode or its prefill kernels
    (``kernel_name``), no reduction, and the activation quantization for
    w4a8."""
    name = "int4_ffn_a8" if act_quant else "int4_ffn"
    return {kernel_name(name, m): 2, "int4_act_quant": int(act_quant)}


def int4_ffn_plan_on(xm: torch.Tensor, inter: int, group: int, act_quant: bool) -> tuple:
    """``int4_ffn_plan`` of a K7 call on the (m, hidden) rows xm on its card
    (the decode kernels' cluster occupancy queried once per row tier, scale
    groups and form)."""
    m, hidden = xm.shape
    clusters = ()
    if m <= STREAM_MAX_ROWS:
        g_h, g_i = _int4_group(hidden, group), _int4_group(inter, group)
        lib = build.library().lib
        clusters = _cluster_occupancy(
            ("int4_ffn", xm.device, _row_tier(m), g_h, g_i, act_quant),
            lambda down, s: lib.int4_ffn_stream_clusters(m, g_h, g_i, int(act_quant), down, s), 2)
    return int4_ffn_plan(m, hidden, inter, group, clusters)


def _int4_ffn_kernel(x, wg4, sg, wu4, su, wd4, sd, group: int, act_quant: bool):
    *lead, hidden = x.shape
    inter = sg.shape[1]
    g_h, g_i = _int4_group(hidden, group), _int4_group(inter, group)
    _kernel_limits(x, g_h)
    _kernel_limits(x, g_i)
    bj = ffn_block_j(inter, g_i)
    n_j = _rup(inter, bj) // bj
    xm = _aligned(x.reshape(-1, hidden))
    m = xm.shape[0]
    ws = [_aligned(t) for t in (wg4, sg, wu4, su, wd4, sd)]
    sx = None
    if act_quant:
        xm, sx = _quantize_act_kernel(xm)
    out = torch.empty(m, hidden, dtype=x.dtype, device=x.device)
    # h between the two launches: (m, n_j bj) bf16, or int8 with its row
    # scales per j-block sh (m, n_j)
    h = torch.empty(m, n_j * bj, dtype=torch.int8 if act_quant else torch.bfloat16,
                    device=x.device)
    sh = torch.empty(m, n_j, device=x.device) if act_quant else None
    ptrs = (xm.data_ptr(), sx.data_ptr() if act_quant else None, *(t.data_ptr() for t in ws),
            out.data_ptr(), h.data_ptr(), sh.data_ptr() if act_quant else None)
    lib, stream = build.library().lib, _stream(x)
    name = kernel_name("int4_ffn_a8" if act_quant else "int4_ffn", m)
    plan = int4_ffn_plan_on(xm, inter, group, act_quant)
    if plan[0] == "stream":
        _, gu, gu_per, dn, dn_per = plan
        rc = lib.int4_ffn_stream_launch(*ptrs, m, hidden, inter, g_h, g_i, bj, gu_per, gu,
                                        dn_per, dn, int(act_quant), stream)
    else:
        rc = lib.int4_ffn_prefill_launch(*ptrs, m, hidden, inter, g_h, g_i, bj, int(act_quant),
                                         stream)
    build.check_launch(rc, name)
    LAUNCHES[name] += 2
    return out.reshape(*lead, hidden)


def int4_ffn(x, wg4, sg, wu4, su, wd4, sd, group: int = GROUP, impl: str = "pallas",
             act_quant: bool = False) -> torch.Tensor:
    """down(silu(x Wg) * (x Wu)) with packed int4 gate/up (hidden/2, inter)
    and down (inter/2, hidden) weights and their group scales -> (...,
    hidden) in x's dtype: on the card two launches, the decode kernels up to
    STREAM_MAX_ROWS rows, else the prefill kernels (``int4_ffn_plan``)."""
    g_h, g_i = _check_ffn(x, wg4, sg, wu4, su, wd4, sd, group)
    if impl == "xla":
        return _int4_ffn_xla(x, wg4, sg, wu4, su, wd4, sd, g_h, g_i, act_quant)
    if impl != "pallas":
        raise ValueError(f"unknown impl {impl!r}")
    if _device(x) == "cpu":
        return int4_ffn_plain(x, wg4, sg, wu4, su, wd4, sd, group, act_quant)
    return _int4_ffn_kernel(x, wg4, sg, wu4, su, wd4, sd, group, act_quant)


# ------------------------------------------------------------------ K4

def _int_dot(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The exact integer product of int8 (or integer-valued) matrices (m, k)
    @ (k, n), rounded once to fp32 as the kernels convert their int32 sums:
    fp64 holds every such sum exactly (|sum| <= k 127^2 < 2^53), where fp32
    stops at 2^24 (k 1,040 at full-scale operands)."""
    return (a8.double() @ b8.double()).float()


def _check_matmul8(x, w8, scale):
    if w8.dtype != torch.int8 or w8.ndim != 2:
        raise ValueError(f"w8 must be int8 (in, out), got {w8.dtype} {tuple(w8.shape)}")
    if w8.shape[0] != x.shape[-1]:
        raise ValueError(f"x's last dim {x.shape[-1]} does not match w8 {tuple(w8.shape)}")
    if tuple(scale.shape) != (w8.shape[1],) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be fp32 {(w8.shape[1],)}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if len({x.device, w8.device, scale.device}) != 1:
        raise ValueError("all inputs must be on one device")


def int8_matmul_plain(x, w8, scale, act_quant: bool = False):
    """The kernel's function in plain PyTorch, and ctpa's xla branch: w8 sums
    x . w8 in fp32 (the int8 weight is exact in x's dtype) and scales the
    columns after; w8a8 takes the exact int32 dot of the per-token int8 x,
    times its row scale, times the column scale."""
    *lead, d_in = x.shape
    xm = x.reshape(-1, d_in)
    if act_quant:
        x8, sx = quantize_act_int8(xm)
        y = _int_dot(x8, w8) * sx * scale
    else:
        y = (xm.float() @ w8.float()) * scale
    return y.to(x.dtype).reshape(*lead, w8.shape[1])


def int8_matmul_stream_splits(d_in: int, d_out: int, clusters: tuple) -> tuple[int, int]:
    """(splits, ring stages per split) of K4's decode kernel: its contraction
    in stages of INT8_STREAM_KC rows, at least FFN_STREAM_MIN_STAGES a split;
    the splits of a STREAM_COLUMNS-column strip form one cluster, and the
    kernel takes the most (up to FFN_STREAM_MAX_SPLITS) with which every
    strip's cluster runs at once (``clusters[s - 1]``: how many clusters of
    s blocks the card runs at once)."""
    stages = math.ceil(d_in / INT8_STREAM_KC)
    splits = cluster_splits(clusters, stages // FFN_STREAM_MIN_STAGES,
                            math.ceil(d_out / STREAM_COLUMNS))
    per = math.ceil(stages / splits)
    return math.ceil(stages / per), per


def int8_matmul_plan(m: int, d_in: int, d_out: int, clusters: tuple) -> tuple:
    """The kernel of a K4 call on m rows, one launch either way: ("stream",
    splits, stages per split) up to STREAM_MAX_ROWS rows, the
    weight-streaming kernel adding its splits in its clusters; else
    ``prefill_plan``'s ("wgmma", token tiles, strips, splits, chunks per
    split).  ``clusters``: the chosen kernel's cluster occupancy table."""
    if m <= STREAM_MAX_ROWS:
        return ("stream", *int8_matmul_stream_splits(d_in, d_out, clusters))
    return prefill_plan(m, d_in, d_out, clusters)


def int8_matmul_launches(m: int, act_quant: bool) -> dict:
    """The launches of one K4 call on m rows, under ``LAUNCHES``' names: its
    kernel once (``kernel_name``), and the activation quantization for
    w8a8."""
    return {kernel_name("int8_matmul_a8" if act_quant else "int8_matmul", m): 1,
            "int4_act_quant": int(act_quant)}


def int8_matmul_plan_on(xm: torch.Tensor, d_out: int, act_quant: bool) -> tuple:
    """``int8_matmul_plan`` of a K4 call on the (m, in) rows xm on its card
    (the decode kernel's cluster occupancy queried once per row tier and
    form, the prefill kernel's once per form)."""
    m, d_in = xm.shape
    lib = build.library().lib
    if m <= STREAM_MAX_ROWS:
        key, query = (("int8_matmul", xm.device, _row_tier(m), act_quant),
                      lambda _, s: lib.int8_matmul_stream_clusters(m, int(act_quant), s))
    else:
        key, query = (("int8_matmul_prefill", xm.device, act_quant),
                      lambda _, s: lib.int8_matmul_prefill_clusters(int(act_quant), s))
    return int8_matmul_plan(m, d_in, d_out, _cluster_occupancy(key, query, 1)[0])


def _int8_matmul_kernel(x, w8, scale, act_quant: bool):
    *lead, d_in = x.shape
    d_out = w8.shape[1]
    _bf16_only(x, "int8")
    xm = _aligned(x.reshape(-1, d_in))
    m = xm.shape[0]
    w8, scale = _aligned(w8), _aligned(scale)
    sx = None
    if act_quant:
        xm, sx = _quantize_act_kernel(xm)
    out = torch.empty(m, d_out, dtype=x.dtype, device=x.device)
    kernel, *_, splits, per = int8_matmul_plan_on(xm, d_out, act_quant)
    launch = (build.library().lib.int8_matmul_stream_launch if kernel == "stream"
              else build.library().lib.int8_matmul_prefill_launch)
    rc = launch(xm.data_ptr(), sx.data_ptr() if act_quant else None, w8.data_ptr(),
                scale.data_ptr(), out.data_ptr(), m, d_in, d_out, per, splits, int(act_quant),
                _stream(x))
    name = kernel_name("int8_matmul_a8" if act_quant else "int8_matmul", m)
    build.check_launch(rc, name)
    LAUNCHES[name] += 1
    return out.reshape(*lead, d_out)


def int8_matmul(x, w8, scale, impl: str = "pallas", act_quant: bool = False) -> torch.Tensor:
    """(..., in) x against int8 (in, out) weights with an (out,) fp32 scale
    -> (..., out) in x's dtype.  ``act_quant`` is w8a8."""
    _check_matmul8(x, w8, scale)
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "xla" or _device(x) == "cpu":
        return int8_matmul_plain(x, w8, scale, act_quant)
    return _int8_matmul_kernel(x, w8, scale, act_quant)


# ------------------------------------------------------------------ K6

def _check_ffn8(x, wg8, sg, wu8, su, wd8, sd):
    hidden = x.shape[-1]
    inter = wg8.shape[-1]
    shapes = {"wg8": (wg8, (hidden, inter), torch.int8), "wu8": (wu8, (hidden, inter), torch.int8),
              "wd8": (wd8, (inter, hidden), torch.int8), "sg": (sg, (inter,), torch.float32),
              "su": (su, (inter,), torch.float32), "sd": (sd, (hidden,), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")


def int8_ffn_plain(x, wg8, sg, wu8, su, wd8, sd, act_quant: bool = False,
                   block_j: int = INT8_BLOCK_J):
    """The kernel's function in plain PyTorch (ctpa's ``int8_ffn``):
    down(silu(x Wg) * (x Wu)).  w8: g and u fp32 with their column scales,
    h rounded to x's dtype, the down sum in fp32, then its column scale.
    w8a8: g and u from exact int32 dots, h in fp32, requantized per row per
    ``block_j`` columns; each j-block's exact down dot times its row scale,
    summed over the j-blocks in order, then the column scale."""
    *lead, hidden = x.shape
    inter = wg8.shape[1]
    dt = x.dtype
    xm = x.reshape(-1, hidden)
    if not act_quant:
        xf = xm.float()
        g = (xf @ wg8.float()) * sg
        u = (xf @ wu8.float()) * su
        h = (g * torch.sigmoid(g) * u).to(dt)
        return ((h.float() @ wd8.float()) * sd).to(dt).reshape(*lead, hidden)
    x8, sx = quantize_act_int8(xm)
    g = _int_dot(x8, wg8) * sx * sg
    u = _int_dot(x8, wu8) * sx * su
    h = g * torch.sigmoid(g) * u
    acc = torch.zeros(xm.shape[0], hidden, device=x.device)
    for j0 in range(0, inter, block_j):
        hj = h[:, j0:j0 + block_j]                     # ctpa's pad columns are 0
        sh = torch.clamp(hj.abs().amax(-1, keepdim=True) / 127.0, min=1e-12)
        h8 = torch.clamp(torch.round(hj / sh), -127, 127)
        acc = acc + _int_dot(h8, wd8[j0:j0 + block_j]) * sh
    return (acc * sd).to(dt).reshape(*lead, hidden)


def _int8_ffn_xla(x, wg8, sg, wu8, su, wd8, sd, act_quant: bool):
    """ctpa's int8 FFN with ``quant_impl="xla"`` (``LlamaMLP``): three int8
    projections, silu(gate) * up in x's dtype between them."""
    gate = int8_matmul_plain(x, wg8, sg, act_quant)
    up = int8_matmul_plain(x, wu8, su, act_quant)
    return int8_matmul_plain(torch.nn.functional.silu(gate) * up, wd8, sd, act_quant)


def int8_ffn_stream_splits(hidden: int, inter: int,
                           clusters: tuple) -> tuple[int, int, int, int]:
    """(gate/up splits, ring stages per split, down splits, j-blocks per
    split) of K6's decode kernels.  The splits of one j-block (gate/up) or
    column strip (down) run as one cluster; ``clusters[k][s - 1]`` is how
    many clusters of s blocks kernel k (0 gate/up, 1 down) runs at once on
    the card.  Each kernel takes the most splits, up to FFN_STREAM_MAX_SPLITS
    (the gate/up kernel's at least FFN_STREAM_MIN_STAGES stages each, the
    down kernel's whole j-blocks), with which all its clusters run at once."""
    n_j = _rup(inter, INT8_BLOCK_J) // INT8_BLOCK_J
    stages = math.ceil(hidden / FFN_STREAM_KC)
    strips = math.ceil(hidden / FFN_STREAM_COLUMNS)
    gu = cluster_splits(clusters[0], stages // FFN_STREAM_MIN_STAGES, n_j)
    gu_per = math.ceil(stages / gu)
    dn = cluster_splits(clusters[1], n_j, strips)
    dn_per = math.ceil(n_j / dn)
    return math.ceil(stages / gu_per), gu_per, math.ceil(n_j / dn_per), dn_per


def int8_ffn_plan(m: int, hidden: int, inter: int, clusters: tuple) -> tuple:
    """The kernels of a K6 call on m rows: ("stream", gate/up splits, stages
    per split, down splits, j-blocks per split) up to STREAM_MAX_ROWS rows
    (``clusters`` as ``int8_ffn_stream_splits`` takes it), else ("wgmma",
    j-blocks, output strips): the prefill kernels, gate/up over one block
    column a j-block, down over one a PREFILL_COLUMNS-column strip."""
    if m <= STREAM_MAX_ROWS:
        return ("stream", *int8_ffn_stream_splits(hidden, inter, clusters))
    return ("wgmma", _rup(inter, INT8_BLOCK_J) // INT8_BLOCK_J,
            math.ceil(hidden / PREFILL_COLUMNS))


def int8_ffn_launches(m: int, hidden: int, inter: int, act_quant: bool) -> dict:
    """The launches of one K6 call on m rows, under ``LAUNCHES``' names: two
    (gate/up, down) at any row count, of its decode or its prefill kernels
    (``kernel_name``), no reduction, and the activation quantization for
    w8a8."""
    name = "int8_ffn_a8" if act_quant else "int8_ffn"
    return {kernel_name(name, m): 2, "int4_act_quant": int(act_quant)}


def int8_ffn_plan_on(xm: torch.Tensor, inter: int, act_quant: bool) -> tuple:
    """``int8_ffn_plan`` of a K6 call on the (m, hidden) rows xm on its card
    (the decode kernels' cluster occupancy queried once per row tier and
    form)."""
    m, hidden = xm.shape
    clusters = ()
    if m <= STREAM_MAX_ROWS:
        lib = build.library().lib
        clusters = _cluster_occupancy(
            ("int8_ffn", xm.device, _row_tier(m), act_quant),
            lambda down, s: lib.int8_ffn_stream_clusters(m, int(act_quant), down, s), 2)
    return int8_ffn_plan(m, hidden, inter, clusters)


def _int8_ffn_kernel(x, wg8, sg, wu8, su, wd8, sd, act_quant: bool):
    *lead, hidden = x.shape
    inter = wg8.shape[1]
    _bf16_only(x, "int8")
    if hidden % 16:
        raise ValueError(f"the int8 FFN kernel takes a hidden size that is a multiple of 16, "
                         f"got {hidden}")
    n_j = _rup(inter, INT8_BLOCK_J) // INT8_BLOCK_J
    xm = _aligned(x.reshape(-1, hidden))
    m = xm.shape[0]
    ws = [_aligned(t) for t in (wg8, sg, wu8, su, wd8, sd)]
    sx = None
    if act_quant:
        xm, sx = _quantize_act_kernel(xm)
    out = torch.empty(m, hidden, dtype=x.dtype, device=x.device)
    # h between the two launches: (m, 256 n_j) bf16, or int8 with its row
    # scales per j-block sh (m, n_j)
    h = torch.empty(m, n_j * INT8_BLOCK_J, dtype=torch.int8 if act_quant else torch.bfloat16,
                    device=x.device)
    sh = torch.empty(m, n_j, device=x.device) if act_quant else None
    ptrs = (xm.data_ptr(), sx.data_ptr() if act_quant else None, *(t.data_ptr() for t in ws),
            out.data_ptr(), h.data_ptr(), sh.data_ptr() if act_quant else None)
    lib, stream = build.library().lib, _stream(x)
    name = kernel_name("int8_ffn_a8" if act_quant else "int8_ffn", m)
    plan = int8_ffn_plan_on(xm, inter, act_quant)
    if plan[0] == "stream":
        _, gu, gu_per, dn, dn_per = plan
        rc = lib.int8_ffn_stream_launch(*ptrs, m, hidden, inter, gu_per, gu, dn_per, dn,
                                        int(act_quant), stream)
    else:
        rc = lib.int8_ffn_prefill_launch(*ptrs, m, hidden, inter, int(act_quant), stream)
    build.check_launch(rc, name)
    LAUNCHES[name] += 2
    return out.reshape(*lead, hidden)


def int8_ffn(x, wg8, sg, wu8, su, wd8, sd, impl: str = "pallas",
             act_quant: bool = False) -> torch.Tensor:
    """down(silu(x Wg) * (x Wu)) with int8 gate/up (hidden, inter) and down
    (inter, hidden) weights and their per-column scales -> (..., hidden) in
    x's dtype: on the card two launches, the decode kernels up to
    STREAM_MAX_ROWS rows, else the prefill kernels (``int8_ffn_plan``)."""
    _check_ffn8(x, wg8, sg, wu8, su, wd8, sd)
    if impl == "xla":
        return _int8_ffn_xla(x, wg8, sg, wu8, su, wd8, sd, act_quant)
    if impl != "pallas":
        raise ValueError(f"unknown impl {impl!r}")
    if _device(x) == "cpu":
        return int8_ffn_plain(x, wg8, sg, wu8, su, wd8, sd, act_quant)
    return _int8_ffn_kernel(x, wg8, sg, wu8, su, wd8, sd, act_quant)


# ------------------------------------------------------------------ quantize_tree

QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
                 "lm_head")


def quantize_tree(state: dict, *, targets: tuple[str, ...] = QUANT_TARGETS, fuse: bool = True,
                  ffn_kernel: bool = False, lora=None, bits: int = 8,
                  group: int = GROUP) -> dict:
    """A ``state_dict`` for quantized serving (ctpa's ``quantize_tree`` on the
    port's names): every 2-D ``weight`` under a targeted projection becomes
    {``kernel_q``, ``scale``} (bits 8) or {``kernel_q``, ``scale_g``} (bits
    4) in ctpa's (in, out) layout; a LoRA projection's ``<proj>.base``
    level collapses into ``<proj>``.  Trained LoRA adapters are merged first
    (``models/lora.py:merge_lora_scaled``, which needs ``lora``, the
    training LoRAConfig) and dropped.  ``fuse`` concatenates q/k/v into
    ``qkv_proj`` and, unless ``ffn_kernel`` (which keeps gate/up/down
    apart for the fused FFN), gate/up into ``gateup_proj``, along the
    output columns."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    from ctpa_torch.models.lora import is_lora, merge_lora_scaled

    def quant(w_in_out):
        if bits == 4:
            w4, s = quantize_int4(w_in_out, group)
            return {"kernel_q": w4, "scale_g": s}
        w8, s = quantize_int8(w_in_out)
        return {"kernel_q": w8, "scale": s}

    has_lora = any(is_lora(k) for k in state)
    if has_lora:
        if lora is None:
            raise ValueError("state contains LoRA adapters (lora_a/lora_b); pass the training "
                             "LoRAConfig so the deltas are merged before quantization "
                             "(quantize_tree(..., lora=cfg))")
        state = merge_lora_scaled(state, lora.alpha, lora.rank)
    fuse_groups = {"qkv_proj": ("q_proj", "k_proj", "v_proj")}
    if not ffn_kernel:
        fuse_groups["gateup_proj"] = ("gate_proj", "up_proj")
    fused_members = {m for g in fuse_groups.values() for m in g} if fuse else set()
    out: dict = {}
    pending: dict = {}                     # parent prefix -> {projection: (in, out) weight}
    for key, value in state.items():
        parts = key.split(".")
        if has_lora and is_lora(key):
            continue
        if parts[-1] == "weight" and value.ndim == 2 and any(t in parts for t in targets):
            base = parts[:-1]
            if base[-1] == "base":
                base = base[:-1]
            proj, parent = base[-1], ".".join(base[:-1])
            if proj in fused_members:
                pending.setdefault(parent, {})[proj] = value.T
                continue
            for leaf, q in quant(value.T).items():
                out[".".join(base + [leaf])] = q
        else:
            out[key] = value
    for parent, weights in pending.items():
        consumed = set()
        for fused, members in fuse_groups.items():
            if not any(m in weights for m in members):
                continue
            missing = [m for m in members if m not in weights]
            if missing:
                raise ValueError(f"fuse group {fused} incomplete under {parent}: missing "
                                 f"{missing} (pass fuse=False or include all group members "
                                 "in targets)")
            w = torch.cat([weights[m] for m in members], dim=1)
            for leaf, q in quant(w).items():
                out[f"{parent}.{fused}.{leaf}"] = q
            consumed.update(members)
        leftover = set(weights) - consumed
        if leftover:
            raise AssertionError(f"unconsumed fused members {leftover}")
    return out
