"""The port's BERT LoRA, LLM remat, NLG metrics and BERT-decoder VQA model
against ctpa's on the CPU.

The same numpy-seeded inputs and weights (carried into the port by
``ctpa_torch.convert``) go through ctpa's function and the port's; no
hand-written kernel is on these paths.

Tolerances (fp32 on both sides, differing only in the order of sums):
  * BERT with LoRA: hidden states within 1e-5; a fresh adapter (B zero) is
    the identity, bit for bit;
  * remat: loss and gradients bit-equal to the same model without remat,
    and within 1e-6 of ctpa's remat model (gradients 1e-6 abs + 1e-5 rel:
    sums of many terms of order 1);
  * NLG: BLEU and ROUGE equal (the same host code); BERTScore P/R/F1, with
    IDF and baseline, within 1e-6 given the same embeddings;
    ``make_bert_embed_fn`` embeddings within 1e-5;
  * ``MedicalVQAModel``: logits within 1e-5, loss within 1e-6, greedy tokens
    equal, the trainable mask equal, and the parameters after one optimizer
    step within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core import config as jc
from ctpa.eval import nlg as jnlg
from ctpa.models import bert as jbert
from ctpa.models import report_generator as jrg
from ctpa.models import vqa_bert as jvqa
from ctpa_torch.convert import flax_to_state_dict, load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.data.tokenizer import SimpleWordTokenizer
from ctpa_torch.eval import nlg as tnlg
from ctpa_torch.models import llm as tllm
from ctpa_torch.models import vqa_bert as tvqa
from ctpa_torch.models.bert import BertEncoder
from ctpa_torch.models.report_generator import CTReportGenerator

torch.set_num_threads(1)
KEY = jax.random.key(0)
ATOL = 1e-5
EXACT = 1e-6
TBERT, TVIT, TLLM = tc.BertConfig.tiny(), tc.CTViTConfig.tiny(), tc.LLMConfig.tiny()


def jcfg(cfg, **over):
    """ctpa's config with the port config's field values."""
    jtype = {tc.CTViTConfig: jc.CTViTConfig, tc.BertConfig: jc.BertConfig,
             tc.LLMConfig: jc.LLMConfig}[type(cfg)]
    return jtype(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}, **over})


JBERT, JVIT, JLLM = jcfg(TBERT), jcfg(TVIT), jcfg(TLLM)


def np_params(tree, seed, scale=0.2, lora_b=True):
    """Numpy draws for a flax param tree: gains near 1, the rest at
    ``scale`` N(0, 1); LoRA B zero unless ``lora_b``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight", "norm_in_scale"):
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        if name.endswith("lora_b") and not lora_b:
            return np.zeros(shape, np.float32)
        return np.asarray(scale * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _tokens(seed, b=2, n=7, vocab=TBERT.vocab_size):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.int32)
    mask[1, 4:] = 0
    return (rng.integers(1, vocab, size=(b, n)) * mask).astype(np.int32), mask


def _video(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 1, TVIT.temporal_size, TVIT.image_size,
                                    TVIT.image_size)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------- BERT with LoRA

@pytest.mark.parametrize("lora_b", [True, False])
def test_bert_lora_matches_ctpa(lora_b):
    """LoRA rank 4, alpha 8 on query/key/value: the port's hidden states and
    CLS embedding against ctpa's; with B at zero (a fresh adapter) the
    port's encoder gives the bits of the same encoder without LoRA."""
    jm = jbert.BertEncoder(JBERT, lora_rank=4, lora_alpha=8.0)
    ids, mask = _tokens(1)
    shapes = jax.eval_shape(lambda: jm.init(KEY, ids, mask))["params"]
    params = jax.tree.map(np.asarray, np_params(shapes, 2, lora_b=lora_b))
    assert "query_lora_a" in params["layer_0"]["attention_self"]
    ref, ref_cls = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    tm = load_flax_params(BertEncoder(TBERT, device="cpu", lora_rank=4, lora_alpha=8.0), params)
    assert "layers.0.attention_self.value_lora_b" in dict(tm.named_parameters())
    with torch.no_grad():
        got, cls = tm(_t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), atol=ATOL)
    if not lora_b:
        base = {k: v for k, v in tm.state_dict().items() if "lora" not in k}
        plain = BertEncoder(TBERT, device="cpu")
        plain.load_state_dict(base)
        with torch.no_grad():
            assert torch.equal(plain(_t(ids).long(), _t(mask))[0], got)
    fresh = BertEncoder(TBERT, device="cpu", lora_rank=4)
    assert all(not p.any() for n, p in fresh.named_parameters() if n.endswith("lora_b"))


# ------------------------------------------------------- remat in the LLM

def _report_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ids = (rng.integers(1, TLLM.vocab_size, size=(2, 9)) * mask).astype(np.int32)
    return _video(seed), ids, mask


def test_llm_remat_matches_plain_and_ctpa(monkeypatch):
    """CTReportGenerator with LoRA (rank 4) and remat: the loss and every
    gradient equal the same model's without remat, bit for bit, and ctpa's
    remat model's within 1e-6; the forward runs each block once more in the
    backward."""
    jlora, tlora = jc.LoRAConfig(rank=4, alpha=8.0), tc.LoRAConfig(rank=4, alpha=8.0)
    gen_j, gen_t = jc.ReportGenConfig(vision_dim=24), tc.ReportGenConfig(vision_dim=24)
    jm = jrg.CTReportGenerator(JLLM, JVIT, gen_j, lora=jlora, remat=True)
    video, ids, mask = _report_batch(3)
    shapes = jax.eval_shape(lambda: jm.init(KEY, video, ids, mask))["params"]
    params = jax.tree.map(np.asarray, np_params(shapes, 4, scale=0.1))

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
                        method=jrg.CTReportGenerator.loss)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref_grads = flax_to_state_dict(jax.tree.map(np.asarray, ref_grads))
    calls = []
    block_forward = tllm.LlamaBlock.forward

    def counted(self, *args):
        calls.append(1)
        return block_forward(self, *args)

    monkeypatch.setattr(tllm.LlamaBlock, "forward", counted)
    runs = {}
    for remat in (False, True):
        tm = load_flax_params(CTReportGenerator(TLLM, TVIT, gen_t, lora=tlora, device="cpu",
                                                remat=remat), params)
        calls.clear()
        loss = tm.loss(_t(video), _t(ids).long(), _t(mask))
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in tm.named_parameters()}, len(calls))
    assert runs[False][2] == TLLM.num_layers and runs[True][2] == 2 * TLLM.num_layers
    assert torch.equal(runs[True][0], runs[False][0])
    for name, g in runs[True][1].items():
        assert torch.equal(g, runs[False][1][name]), name
    np.testing.assert_allclose(runs[True][0].item(), float(ref_loss), atol=EXACT, rtol=0)
    for name, g in runs[True][1].items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name], atol=EXACT, rtol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------- NLG metrics

WORDS = "the lung is clear no nodule pleural effusion small opacity right left lobe".split()


def _texts(seed, n=6):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(0 if i == 0 else 1, 12)))
            for i in range(n)]


def _fake_embed(seed, d=8):
    """An embed_fn of seeded per-word vectors: (emb, mask, ids)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(len(WORDS) + 1, d))

    def embed(texts):
        n = max(len(t.split()) for t in texts) + 1
        ids = np.zeros((len(texts), n), np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for i, t in enumerate(texts):
            toks = [len(WORDS)] + [WORDS.index(w) for w in t.split()]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return table[ids], mask, ids

    return embed


def test_bleu_rouge_match_ctpa():
    refs, hyps = _texts(5), _texts(6)
    for r, h in zip(refs + ["a b c d"], hyps + ["a b c d"]):
        rt, ht = r.split(), h.split()
        for n in (1, 2, 4):
            assert tnlg.bleu(rt, ht, max_n=n) == jnlg.bleu(rt, ht, max_n=n)
        assert tnlg.rouge_n(rt, ht, 2) == jnlg.rouge_n(rt, ht, 2)
        assert tnlg.rouge_l(rt, ht) == jnlg.rouge_l(rt, ht)
    assert tnlg.NLGEvaluator().evaluate(refs, hyps) == jnlg.NLGEvaluator().evaluate(refs, hyps)


@pytest.mark.parametrize("use_idf", [False, True])
@pytest.mark.parametrize("baseline", [None, (0.3, 0.25, 0.28)])
def test_bertscore_matches_ctpa(use_idf, baseline):
    """NLGEvaluator with one embed_fn on both sides, and the random-pair
    baseline: within 1e-6."""
    refs, hyps = _texts(7), _texts(8)
    refs[0] = hyps[0] = ""
    embed = _fake_embed(9)
    got = tnlg.NLGEvaluator(embed, bertscore_baseline=baseline, use_idf=use_idf).evaluate(
        refs, hyps)
    ref = jnlg.NLGEvaluator(embed, bertscore_baseline=baseline, use_idf=use_idf).evaluate(
        refs, hyps)
    assert sorted(got) == sorted(ref) and "bertscore_f1" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=EXACT, err_msg=k)
    corpus = _texts(10, n=9)
    got_b = tnlg.compute_bertscore_baseline(embed, corpus, use_idf=use_idf)
    ref_b = jnlg.compute_bertscore_baseline(embed, corpus, use_idf=use_idf)
    assert got_b["n_pairs"] == ref_b["n_pairs"] == 9
    for k in ("precision", "recall", "f1"):
        np.testing.assert_allclose(got_b[k], ref_b[k], atol=EXACT)
    assert tnlg.compute_idf([[1, 2], [2, 3]]) == jnlg.compute_idf([[1, 2], [2, 3]])


def test_bert_embed_fn_matches_ctpa():
    """make_bert_embed_fn on the CPU: hidden states within 1e-5, the
    tokenizer's mask and ids as they are."""
    jm = jbert.BertEncoder(JBERT)
    ids, mask = _tokens(11)
    params = {"params": jax.tree.map(np.asarray, np_params(
        jax.eval_shape(lambda: jm.init(KEY, ids, mask))["params"], 12))}
    tok = SimpleWordTokenizer(vocab_size=TBERT.vocab_size, max_length=16)
    texts = _texts(13, n=3)
    ref = jnlg.make_bert_embed_fn(params, JBERT, tok, max_length=16)(texts)
    got = tnlg.make_bert_embed_fn(params, TBERT, tok, max_length=16, device="cpu")(texts)
    assert got[0].shape == np.asarray(ref[0]).shape == (3, 16, TBERT.hidden_size)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=ATOL)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))


# ------------------------------------------------------- MedicalVQAModel

@pytest.fixture(scope="module")
def vqa_pair():
    jm = jvqa.MedicalVQAModel(JBERT, JVIT, vision_dim=24, lora_rank=4, lora_alpha=8.0)
    ids, mask = _tokens(14)
    shapes = jax.eval_shape(lambda: jm.init(KEY, _video(15), ids, mask))["params"]
    params = jax.tree.map(np.asarray, np_params(shapes, 16, scale=0.1))
    tm = load_flax_params(tvqa.MedicalVQAModel(TBERT, TVIT, vision_dim=24, lora_rank=4,
                                               lora_alpha=8.0, device="cpu"), params)
    return jm, params, tm


def test_vqa_logits_loss_and_greedy_match_ctpa(vqa_pair):
    jm, params, tm = vqa_pair
    video, (ids, mask) = _video(17), _tokens(18)
    v = {"params": params}
    ref = jm.apply(v, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask))
    ref_loss = jm.apply(v, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
                        method=jvqa.MedicalVQAModel.loss)
    with torch.no_grad():
        got = tm(_t(video), _t(ids).long(), _t(mask))
        loss = tm.loss(_t(video), _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=EXACT)
    # a SEP id that the greedy run emits, so one sequence stops early
    free = tm.generate(_t(video), _t(ids).long(), _t(mask), 5, sep_token_id=-1)[0]
    sep = int(free[0, 7 + 1])
    ref_ids, ref_len = jm.apply(v, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask), 5,
                                sep, method=jvqa.MedicalVQAModel.generate)
    got_ids, got_len = tm.generate(_t(video), _t(ids).long(), _t(mask), 5, sep_token_id=sep)
    assert np.array_equal(got_ids.numpy(), np.asarray(ref_ids))
    assert np.array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got_len[0] < 7 + 5
    gen = torch.Generator().manual_seed(0)
    drawn, lengths = tm.generate(_t(video), _t(ids).long(), _t(mask), 3, sep_token_id=-1,
                                 temperature=0.7, generator=gen, greedy=False)
    assert torch.equal(drawn[0, :7], _t(ids[0]).long()) and torch.equal(drawn[1, :4],
                                                                          _t(ids[1, :4]).long())
    assert (lengths == _t(mask).sum(-1) + 3).all()
    assert ((drawn >= 0) & (drawn < TBERT.vocab_size)).all()


def test_vqa_trainable_mask_and_optimizer_step_match_ctpa(vqa_pair):
    """vqa_trainable_mask under the port's names equals ctpa's; one
    make_vqa_optimizer step on the same gradients (ctpa's, through the
    converter) moves the trainable parameters as optax does, within 1e-6,
    and leaves the frozen ones."""
    import optax

    jm, params, _ = vqa_pair
    tm = load_flax_params(tvqa.MedicalVQAModel(TBERT, TVIT, vision_dim=24, lora_rank=4,
                                               lora_alpha=8.0, device="cpu"), params)
    jmask = jvqa.vqa_trainable_mask(params)
    flat = flax_to_state_dict(jax.tree.map(lambda m, p: np.full(np.shape(p), bool(m)),
                                           jmask, params))
    want = {k: bool(np.ravel(v)[0]) for k, v in flat.items()}
    got = tvqa.vqa_trainable_mask(tm)
    assert got == want
    assert got["text_encoder.layers.0.attention_self.query_lora_a"]
    assert not got["text_encoder.layers.0.attention_self.query.weight"]
    assert not got["vision_extractor.ctvit.patch_embed.proj_kernel"]
    assert got["vision_extractor.proj.weight"] and got["fusion.layers.2.weight"]

    video, (ids, mask) = _video(19), _tokens(20)
    grads = jax.jit(jax.grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
        method=jvqa.MedicalVQAModel.loss)))(params)
    tx = jvqa.make_vqa_optimizer(params, lr=1e-2, t_max=4)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    opt = tvqa.make_vqa_optimizer(tm, lr=1e-2, t_max=4)
    tgrads = flax_to_state_dict(jax.tree.map(np.asarray, grads))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for name, p in tm.named_parameters():
        assert p.requires_grad == want[name]
        if p.requires_grad:
            p.grad = torch.from_numpy(np.array(tgrads[name]))
    opt.step(0)
    for name, p in tm.named_parameters():
        if want[name]:
            np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=EXACT, err_msg=name)
        else:
            assert torch.equal(p, before[name]), name
