"""The port's prompt-lookup speculative decoding against ctpa's, on the CPU:
``_draft_lookup``, ``_spec_accept`` and ``generate_speculative``
(``ctpa/models/report_generator.py:99-178, 314-444``).

The same numpy weights (carried into the port by ``ctpa_torch.convert``)
and the same numpy-seeded inputs go through both.  ctpa runs without
``flash_decode`` (its einsum attention); the port runs it, so its decode
steps go through the decode-attention wrapper's plain version.  Tolerances:
  * drafts, greedy acceptance, greedy tokens, lengths and verify counts:
    equal to ctpa's (the quantized caches' speculative decode is held to
    ctpa's in ``tests/test_torch_streaming.py``, beside its batcher);
  * sampled acceptance, 40,000 draws from an 8-token vocabulary: each
    token's frequency within 5 binomial standard deviations,
    5 sqrt(p (1 - p) / N), of its probability under softmax(filter_logits)
    (about 6e-7 false alarms a token), at position 0 and at position 1
    given an accepted draft; the acceptance rate within 5 deviations of
    p_0(draft_0);
  * sampled generate_speculative against sampled generate, 10,000 lanes
    of each prompt, 3 tokens from a 16-token vocabulary: per position,
    total variation below 0.05 (two independent 10,000-draw samples of one
    16-token law lie at most about 0.025 apart in expectation, with a
    standard deviation near 0.004).
JAX keys and torch generators give other numbers, so sampled runs are held
to their law, not to ctpa's draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core import config as jc
from ctpa.models import report_generator as jrg
from ctpa.ops import sampling as jsamp
from ctpa_torch.convert import load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.models import report_generator as trg
from ctpa_torch.ops import sampling as tsamp

torch.set_num_threads(1)
EOS, PAD = 2, 0
JVIT, TVIT = jc.CTViTConfig.tiny(), tc.CTViTConfig.tiny()


def _t(x):
    return torch.from_numpy(np.array(x))


def np_params(tree, seed, scale=0.2):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight", "norm_in_scale", "gamma", "q_scale", "k_scale"):
            val = 1 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            val = scale * rng.normal(size=shape)
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _inputs(vocab):
    rng = np.random.default_rng(0)
    video = rng.uniform(-1, 1, size=(2, 1, TVIT.temporal_size, TVIT.image_size,
                                     TVIT.image_size)).astype(np.float32)
    mask = np.array([[1] * 10, [1] * 7 + [0] * 3], np.int32)     # real lengths 10 and 7
    return video, rng.integers(3, vocab, size=(2, 10)) * mask, mask


def _pair(seed=12, **llm):
    """ctpa's generator and its params, and the port's with flash_decode
    (where the cache allows it)."""
    jcfg = dataclasses.replace(jc.LLMConfig.tiny(), **llm)
    jm = jrg.CTReportGenerator(jcfg, JVIT, jc.ReportGenConfig(vision_dim=24))
    video, ids, mask = _inputs(jcfg.vocab_size)
    params = np_params(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask)))["params"],
        seed)
    tcfg = dataclasses.replace(tc.LLMConfig.tiny(), flash_decode=llm.get("kv_quant") != "int4",
                               **llm)
    tm = trg.CTReportGenerator(tcfg, TVIT, tc.ReportGenConfig(vision_dim=24), device="cpu")
    return jm, params, load_flax_params(tm, jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ctpa(jm, params, method, **kw):
    video, ids, mask = _inputs(jm.llm_cfg.vocab_size)
    return jm.apply({"params": params}, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
                    eos_token_id=EOS, pad_token_id=PAD, method=method, **kw)


def _port(tm, method, **kw):
    video, ids, mask = _inputs(tm.llm_cfg.vocab_size)
    return getattr(tm, method)(_t(video), _t(ids).long(), _t(mask).long(), eos_token_id=EOS,
                               pad_token_id=PAD, **kw)


def _same(got, ref):
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert np.array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


# ------------------------------------------------------- drafting

@pytest.mark.parametrize("buf,cur_len,fallback,ngram,draft_len,want", [
    # ... 5 6 7 8 ... 5 6 -> the continuation of the earlier (5, 6)
    ([1, 5, 6, 7, 8, 9, 4, 5, 6, 0, 0, 0], 9, 6, 2, 3, [7, 8, 9]),
    ([1, 3, 4, 5, 6, 0, 0, 0], 5, 6, 2, 3, [6, 6, 6]),               # no match: fallback
    ([5, 6, 9, 1, 5, 6, 7, 1, 5, 6, 0, 0], 10, 6, 2, 1, [7]),        # the most recent match
])
def test_draft_lookup_cases(buf, cur_len, fallback, ngram, draft_len, want):
    got = trg._draft_lookup(torch.tensor([buf]), torch.tensor([cur_len]), torch.tensor([fallback]),
                            ngram, draft_len)
    ref = jrg._draft_lookup(jnp.asarray(buf, jnp.int32), jnp.asarray(cur_len),
                            jnp.asarray(fallback), ngram=ngram, draft_len=draft_len)
    assert got[0].tolist() == want == np.asarray(ref).tolist()


@pytest.mark.parametrize("ngram,draft_len", [(1, 4), (2, 8), (3, 5)])
def test_draft_lookup_matches_ctpa_on_random_histories(ngram, draft_len):
    rng = np.random.default_rng(ngram)
    L, b = 24, 64
    buf = rng.integers(0, 4, size=(b, L))                 # 4 symbols: many matches
    cur_len = rng.integers(0, L + 1, size=b)              # empty to full, windows clamped
    fallback = rng.integers(0, 4, size=b)
    ref = jax.jit(jax.vmap(lambda bf, cl, fb: jrg._draft_lookup(bf, cl, fb, ngram, draft_len)))(
        jnp.asarray(buf, jnp.int32), jnp.asarray(cur_len, jnp.int32), jnp.asarray(fallback))
    got = trg._draft_lookup(_t(buf), _t(cur_len), _t(fallback), ngram, draft_len)
    assert np.array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------- acceptance

def test_spec_accept_greedy_matches_ctpa():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(5, 4, 16)).astype(np.float32)
    draft = np.argmax(logits[:, :3], -1)
    draft[1, 1] = (draft[1, 1] + 1) % 16                 # rejected at 1
    draft[2, 0] = (draft[2, 0] + 1) % 16                 # rejected at 0
    e, a = trg._spec_accept(_t(logits), _t(draft), greedy=True)
    je, ja = jrg._spec_accept(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                              jax.random.key(0), greedy=True)
    assert np.array_equal(e.numpy(), np.asarray(je)) and np.array_equal(a.numpy(), np.asarray(ja))
    assert a.tolist() == [3, 1, 0, 3, 3]


def _within(freq, p, n, what):
    bound = 5 * np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= bound + 1e-12).all(), (what, freq, p, bound)


def test_spec_accept_sampled_marginals_follow_plain_sampling():
    V, K, N = 8, 2, 40_000
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(1, K + 1, V)).astype(np.float32)
    d0 = int(np.argmax(logits[0, 0]))                 # draft 0 = p_0's mode: often accepted
    kw = dict(temperature=1.1, top_p=0.98)
    gen = torch.Generator().manual_seed(0)
    e, a = trg._spec_accept(_t(logits).expand(N, K + 1, V), torch.tensor([[d0, 1]]).expand(N, K),
                            gen, greedy=False, **kw)
    e, a = e.numpy(), a.numpy()
    p = torch.softmax(tsamp.filter_logits(_t(logits), **kw), -1).numpy()[0]
    # the same sampling law as ctpa's
    ref = np.asarray(jax.nn.softmax(jsamp.filter_logits(jnp.asarray(logits), **kw), -1))[0]
    np.testing.assert_allclose(p, ref, atol=1e-6)
    _within(np.bincount(e[:, 0], minlength=V) / N, p[0], N, "position 0")
    acc = e[:, 0] == d0
    _within(acc.mean(), p[0, d0], N, "acceptance rate")
    _within(np.bincount(e[acc, 1], minlength=V) / acc.sum(), p[1], acc.sum(), "position 1")
    assert (a[acc] >= 1).all() and (a[~acc] == 0).all()
    assert (e[~acc, 0] != d0).all()                   # a rejected draft is never re-emitted


def test_rollback_invalidates_the_rejected_rows():
    """After a verify of K + 1 = 5 rows from slot 3, each lane keeps its
    committed rows (0-5) and every rejected slot is invalid again, as
    ctpa's rollback leaves them; the slots before the verify stay valid."""
    from ctpa_torch.models.llm import KVCache

    b, m, K = 6, 12, 4
    valid = torch.zeros(b, m, dtype=torch.bool)
    valid[:, :3 + K + 1] = True
    cache = KVCache(k=torch.zeros(1, b, 1, m, 2), v=torch.zeros(1, b, 1, m, 2),
                    write_offset=torch.full((b,), 3 + K + 1, dtype=torch.int32),
                    true_len=torch.full((b,), 3 + K + 1, dtype=torch.int32), valid=valid)
    pre = torch.full((b,), 3, dtype=torch.int32)
    committed = torch.tensor([0, 1, 2, 3, 4, 5])
    out = trg._rollback(cache, pre, pre, committed, K)
    assert out.write_offset.tolist() == out.true_len.tolist() == (3 + committed).tolist()
    assert torch.equal(out.valid, torch.arange(m)[None] < (3 + committed)[:, None])
    assert valid[:, :3 + K + 1].all()                   # the verify's tensors are left as they were


# ------------------------------------------------------- generate_speculative

@pytest.fixture(scope="module")
def greedy_ref(pair):
    jm, params, tm = pair
    return _ctpa(jm, params, jrg.CTReportGenerator.generate, max_new_tokens=12, greedy=True)


@pytest.mark.parametrize("draft_len", [1, 4])
def test_generate_speculative_matches_ctpa(pair, greedy_ref, draft_len):
    jm, params, tm = pair
    got = _port(tm, "generate_speculative", max_new_tokens=12, draft_len=draft_len)
    _same(got, greedy_ref)
    assert got.steps <= 11
    plain = _port(tm, "generate", max_new_tokens=12, greedy=True)
    assert torch.equal(plain.tokens, got.tokens)
    if draft_len == 4:                 # ctpa's own speculative decode, verify for verify
        ref = _ctpa(jm, params, jrg.CTReportGenerator.generate_speculative, max_new_tokens=12,
                    draft_len=draft_len)
        _same(got, ref)
        assert got.steps == int(ref.steps)


def test_generate_speculative_accepts_a_repetitive_output(pair):
    """A zeroed lm_head makes every logit equal (argmax 0): the fallback
    drafts are always right, so the 23 tokens after the first take
    ceil(23 / 5) = 5 verifies of 4 drafts."""
    _, params, tm = pair
    zeroed = trg.CTReportGenerator(tm.llm_cfg, TVIT, tm.gen_cfg, device="cpu")
    load_flax_params(zeroed, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        zeroed.llm.lm_head.weight.zero_()
    got = _port(zeroed, "generate_speculative", max_new_tokens=24, draft_len=4)
    assert got.steps == 5 and (got.tokens == 0).all()         # token 0 is also the pad id


def test_generate_speculative_sampling_near_zero_temperature_is_greedy(pair, greedy_ref):
    _, _, tm = pair
    got = _port(tm, "generate_speculative", max_new_tokens=12, draft_len=4, greedy=False,
                temperature=1e-4, generator=torch.Generator().manual_seed(7))
    _same(got, greedy_ref)


def test_generate_speculative_sampling_has_the_law_of_generate():
    """Per-position marginals of 3 sampled tokens, 10,000 lanes of each of
    two prompts, from generate and from generate_speculative.  The lanes
    share their prompt's vision feature, computed once."""
    _, _, tm = _pair(vocab_size=16)
    video, ids, mask = (_t(x) for x in _inputs(16))
    lanes = 10_000
    with torch.no_grad():
        vision = tm.extract_vision(video).repeat(lanes, 1)
    tm.extract_vision = lambda _video: vision
    args = (video[:1].expand(2 * lanes, *video.shape[1:]), ids.long().repeat(lanes, 1),
            mask.long().repeat(lanes, 1))
    kw = dict(max_new_tokens=3, eos_token_id=-1, pad_token_id=PAD, temperature=0.8)
    plain = tm.generate(*args, greedy=False, generator=torch.Generator().manual_seed(1), **kw)
    spec = tm.generate_speculative(*args, greedy=False, draft_len=3,
                                   generator=torch.Generator().manual_seed(2), **kw)
    for row in range(2):
        for pos in range(3):
            fp = np.bincount(plain.tokens[row::2, pos].numpy(), minlength=16) / lanes
            fs = np.bincount(spec.tokens[row::2, pos].numpy(), minlength=16) / lanes
            assert 0.5 * np.abs(fp - fs).sum() < 0.05, (row, pos)
