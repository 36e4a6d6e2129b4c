"""The split-KV decode-attention kernel's (K8) plan and merge, on the CPU.

``csrc/decode_attention.cu`` splits the slots of one (batch row, kv head)
over a cluster of ``split_count(...)`` blocks, rank r owning the tiles
``rank_slots`` gives it, and rank 0 merges the blocks' softmax states in
rank order.  The kernel runs only on the card (``tests/test_torch_gpu.py``);
here its plan must cover every slot exactly once, and a plain-torch model of
the rank-ordered merge, kept in this file, must give
``decode_attention_plain``'s result within 1e-6 in fp32 (both sum fp32
values in another order), with empty ranks adding exactly nothing and a row
with no valid slot giving zeros, not NaN.
"""

import math

import numpy as np
import pytest
import torch

from ctpa_torch.ops import decode_attention as da

NEG_BIG = -1e30


@pytest.mark.parametrize("rows", [128, 1024])
@pytest.mark.parametrize("m", [1, 37, 608, 2432])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_rank_slots_cover_every_slot_once(rows, m, splits):
    for hd in (16, 32, 64, 128):
        for s in (splits, da.split_count(rows, m, hd, 132)):
            ranges = da.rank_slots(m, hd, s)
            assert len(ranges) == s
            assert ranges[0][0] == 0 and ranges[-1][1] == m
            for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
                assert lo <= hi == nlo                    # contiguous, in rank order
            tile = da.tile_slots(hd)
            assert all(lo % tile == 0 for lo, _ in ranges)
            covered = np.zeros(m, int)
            for lo, hi in ranges:
                covered[lo:hi] += 1
            assert (covered == 1).all()
        chosen = da.split_count(rows, m, hd, 132)
        assert chosen in da.SPLITS and (chosen == 1 or chosen <= math.ceil(m / da.tile_slots(hd)))


@pytest.mark.parametrize("rows, hd, want", [(128, 128, 2), (1024, 128, 1), (32, 128, 8),
                                             (128, 64, 2), (4, 16, 8)])
def test_split_count_keeps_one_wave(rows, hd, want):
    """Meditron-7B at b 4 (128 rows) takes clusters of 2, at b 32 (1,024)
    none, a GQA rep-4 batch of 4 (32 rows) clusters of 8: the most that keep
    the grid within BLOCKS_PER_SM blocks an SM of an H100's 132."""
    assert da.split_count(rows, 608, hd, 132) == want
    for sms in (1, 66, 132, 1000):
        s = da.split_count(rows, 608, hd, sms)
        assert s == 1 or rows * s <= da.BLOCKS_PER_SM * sms


def rank_merge_model(q, ck, cv, valid, layer, ks, vs, scale, splits):
    """The kernel's arithmetic in plain torch, fp32: q pre-scaled by scale *
    log2(e); each rank's (max, sum, acc) over its slots with exp2; rank 0
    merging the ranks in rank order."""
    b, h, hd = q.shape
    kvh, m = ck.shape[2], ck.shape[3]
    qs = (q.float() * (scale * math.log2(math.e))).reshape(b, kvh, h // kvh, hd)
    k, v = ck[layer].float(), cv[layer].float()
    s = torch.einsum("bgrd,bgmd->bgrm", qs, k)
    if ks is not None:
        s = s * ks[layer][:, :, None, :]
    keep = valid[:, None, None, :]
    s = torch.where(keep, s, NEG_BIG)
    states = []
    for lo, hi in da.rank_slots(m, hd, splits):
        sr = s[..., lo:hi]
        mx = sr.amax(-1, keepdim=True) if hi > lo else torch.full_like(s[..., :1], NEG_BIG)
        p = torch.where(keep[..., lo:hi], torch.exp2(sr - mx), 0.0)
        pv = p * vs[layer][:, :, None, lo:hi] if vs is not None else p
        states.append((mx, p.sum(-1, keepdim=True), torch.einsum("bgrm,bgmd->bgrd", pv,
                                                                   v[:, :, lo:hi])))
    top = torch.stack([mx for mx, _, _ in states]).amax(0)
    acc = torch.zeros_like(states[0][2])
    tot = torch.zeros_like(states[0][1])
    for mx, sm, ac in states:                                  # rank order
        c = torch.exp2(mx - top)
        acc = acc + ac * c
        tot = tot + sm * c
    return (acc / torch.clamp(tot, min=1e-30)).reshape(b, h, hd).to(q.dtype)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [37, 608])
@pytest.mark.parametrize("quant", [False, True])
def test_rank_ordered_merge_matches_plain(splits, m, quant):
    rng = np.random.default_rng(splits * 100 + m + quant)
    b, h, kvh, hd, L = 3, 4, 2, 128, 2
    q = torch.from_numpy(rng.normal(size=(b, h, hd)).astype(np.float32))
    shape = (L, b, kvh, m, hd)
    ks = vs = None
    if quant:
        ck, cv = (torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))
                  for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.02, size=shape[:4]).astype(np.float32))
                  for _ in range(2))
    else:
        ck, cv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(2))
    valid = torch.from_numpy(rng.uniform(size=(b, m)) > 0.3)
    ranges = da.rank_slots(m, hd, splits)
    lo, hi = ranges[min(1, splits - 1)]
    valid[0, lo:hi] = False                                   # an empty rank
    valid[2] = False                                          # a row with no valid slot
    got = rank_merge_model(q, ck, cv, valid, 1, ks, vs, hd ** -0.5, splits)
    ref = da.decode_attention_plain(q, ck, cv, valid, 1, ks, vs, hd ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)
    assert not got[2].any()
