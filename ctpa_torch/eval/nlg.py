"""NLG metrics: BLEU, ROUGE-1/2/L, BERTScore (port of ``ctpa/eval/nlg.py``:
the host metrics are an own copy, numpy only; ``make_bert_embed_fn`` runs the
port's ``BertEncoder`` on a device).

Parity with the reference's two evaluator variants (evaluation_module.py:17-224
using nltk+rouge pkg+bert_score; evaluate_reports.py:18-191 using rouge_score)
and the custom metrics of vqa_inference.py:177-242 (perfect-match %, ROUGE-1/L
precision/recall, BLEU-1/4).

The `bert_score` package is not in this environment, so BERTScore is
implemented natively: token embeddings from any encoder callable (the port's
BERT with imported CXR-BERT weights in production; any embedding fn in tests),
greedy cosine matching per the BERTScore paper, with optional IDF weighting
and baseline rescaling.  The reference evaluator runs
`BERTScorer(lang="en", rescale_with_baseline=True)`
(evaluation_module.py:53) — rescaling applies (x - b) / (1 - b) to each of
P/R/F1 with per-metric baseline constants AFTER computing raw F1, exactly as
the bert_score package does; IDF is off by default there and here.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------- BLEU


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    reference: Sequence[str],
    hypothesis: Sequence[str],
    max_n: int = 4,
    smooth: bool = True,
) -> float:
    """Sentence BLEU with uniform weights and +1 smoothing (equivalent to
    nltk sentence_bleu with SmoothingFunction().method1 used at
    evaluation_module.py:139-151)."""
    if len(hypothesis) == 0:
        return 0.0
    precisions = []
    for n in range(1, max_n + 1):
        hyp = _ngrams(hypothesis, n)
        ref = _ngrams(reference, n)
        overlap = sum((hyp & ref).values())
        total = max(sum(hyp.values()), 1)
        if overlap == 0 and smooth:
            precisions.append(1.0 / (2 * total))
        else:
            precisions.append(overlap / total)
    if min(precisions) == 0:
        return 0.0
    log_p = np.mean([np.log(p) for p in precisions])
    bp = 1.0 if len(hypothesis) > len(reference) else np.exp(
        1 - len(reference) / max(len(hypothesis), 1))
    return float(bp * np.exp(log_p))


# ---------------------------------------------------------------- ROUGE


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_n(reference: Sequence[str], hypothesis: Sequence[str], n: int) -> dict:
    ref, hyp = _ngrams(reference, n), _ngrams(hypothesis, n)
    overlap = sum((ref & hyp).values())
    p = overlap / max(sum(hyp.values()), 1)
    r = overlap / max(sum(ref.values()), 1)
    f = 2 * p * r / max(p + r, 1e-12)
    return {"precision": p, "recall": r, "f1": f}


def rouge_l(reference: Sequence[str], hypothesis: Sequence[str]) -> dict:
    lcs = _lcs_len(reference, hypothesis)
    p = lcs / max(len(hypothesis), 1)
    r = lcs / max(len(reference), 1)
    f = 2 * p * r / max(p + r, 1e-12)
    return {"precision": p, "recall": r, "f1": f}


# ---------------------------------------------------------------- BERTScore


def compute_idf(corpora_tokens: Sequence[Sequence]) -> dict:
    """IDF dict over a reference corpus, bert_score `get_idf_dict` semantics:
    idf(w) = log((N + 1) / (df(w) + 1)); unseen tokens default to log(N + 1).
    Tokens may be strings or token ids — anything hashable."""
    n = len(corpora_tokens)
    df = Counter()
    for toks in corpora_tokens:
        df.update(set(toks))
    idf = {w: math.log((n + 1) / (c + 1)) for w, c in df.items()}
    idf["__default__"] = math.log(n + 1)
    return idf


def rescale_with_baseline(scores: dict, baseline: Sequence[float]) -> dict:
    """bert_score rescale_with_baseline semantics (scorer.py: `(preds - b) /
    (1 - b)`): each of P/R/F1 is rescaled with its own baseline constant,
    AFTER raw F1 is computed — F1 is NOT recomputed from rescaled P/R."""
    bp, br, bf = baseline
    return {
        "precision": (scores["precision"] - bp) / (1.0 - bp),
        "recall": (scores["recall"] - br) / (1.0 - br),
        "f1": (scores["f1"] - bf) / (1.0 - bf),
    }


def bert_score(
    ref_emb: np.ndarray, ref_mask: np.ndarray,
    hyp_emb: np.ndarray, hyp_mask: np.ndarray,
    ref_idf: Optional[np.ndarray] = None,
    hyp_idf: Optional[np.ndarray] = None,
    baseline: Optional[Sequence[float]] = None,
) -> dict:
    """Greedy-matching BERTScore from token embeddings.

    ref_emb: (n_r, d); hyp_emb: (n_h, d); masks 1 = real token.
    ref_idf/hyp_idf: optional per-token weights aligned with the UNMASKED
    rows (same length as emb); recall is idf-weighted over reference tokens,
    precision over hypothesis tokens (BERTScore paper eq. 1-2).
    baseline: optional (b_p, b_r, b_f) constants for rescaling
    (evaluation_module.py:53 `rescale_with_baseline=True`)."""
    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)

    rsel = ref_mask.astype(bool)
    hsel = hyp_mask.astype(bool)
    r = norm(ref_emb[rsel])
    h = norm(hyp_emb[hsel])
    if len(r) == 0 or len(h) == 0:
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0}
    rw = np.ones(len(r)) if ref_idf is None else np.asarray(ref_idf, float)[rsel]
    hw = np.ones(len(h)) if hyp_idf is None else np.asarray(hyp_idf, float)[hsel]
    sim = h @ r.T                                  # (n_h, n_r)
    p = float((sim.max(axis=1) * hw).sum() / max(hw.sum(), 1e-12))
    rec = float((sim.max(axis=0) * rw).sum() / max(rw.sum(), 1e-12))
    f = 2 * p * rec / max(p + rec, 1e-12)
    scores = {"precision": p, "recall": rec, "f1": f}
    if baseline is not None:
        scores = rescale_with_baseline(scores, baseline)
    return scores


def compute_bertscore_baseline(
    embed_fn: Callable,
    corpus: Sequence[str],
    seed: int = 0,
    use_idf: bool = False,
) -> dict:
    """Compute (b_p, b_r, b_f) rescaling constants for THIS encoder, the way
    the bert_score package builds its shipped baselines: score UNRELATED
    sentence pairs (a derangement of the corpus) and average the raw P/R/F1.
    Rescaled scores then express "fraction of the way from a random-pair
    score to 1" — comparable across encoders, which the reference's
    `rescale_with_baseline=True` (evaluation_module.py:53) relies on its
    roberta-large constants for.

    Returns {"precision", "recall", "f1", "n_pairs"} — feed the first three
    to NLGEvaluator(bertscore_baseline=...) or persist with
    `save_bertscore_baseline`."""
    sents = [s for s in corpus if s.strip()]
    if len(sents) < 2:
        raise ValueError("need at least 2 non-empty sentences for a baseline")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(sents))
    # derangement by rotation of a shuffled order: i pairs with next(i)
    partners = [sents[order[(k + 1) % len(order)]] for k in range(len(order))]
    firsts = [sents[order[k]] for k in range(len(order))]

    rout = embed_fn(firsts)
    hout = embed_fn(partners)
    re_, rm = rout[0], rout[1]
    he, hm = hout[0], hout[1]
    idf = None
    rids = rout[2] if len(rout) > 2 else None
    hids = hout[2] if len(hout) > 2 else None
    if use_idf:
        if rids is None:
            raise ValueError("use_idf requires embed_fn to return (emb, mask, ids)")
        corpus_tokens = [
            [int(t) for t, m in zip(np.asarray(rids[i]), np.asarray(rm[i])) if m]
            for i in range(len(firsts))
        ]
        idf = compute_idf(corpus_tokens)

    def weights(ids_row):
        if idf is None or ids_row is None:
            return None
        d = idf["__default__"]
        return np.asarray([idf.get(int(t), d) for t in np.asarray(ids_row)])

    ps, rs, fs = [], [], []
    for i in range(len(firsts)):
        bs = bert_score(
            np.asarray(re_[i]), np.asarray(rm[i]),
            np.asarray(he[i]), np.asarray(hm[i]),
            ref_idf=weights(rids[i] if rids is not None else None),
            hyp_idf=weights(hids[i] if hids is not None else None),
        )
        ps.append(bs["precision"]); rs.append(bs["recall"]); fs.append(bs["f1"])
    return {"precision": float(np.mean(ps)), "recall": float(np.mean(rs)),
            "f1": float(np.mean(fs)), "n_pairs": len(firsts)}


def save_bertscore_baseline(path: str, baseline: dict) -> None:
    import json

    with open(path, "w") as f:
        json.dump(baseline, f, indent=2)


def load_bertscore_baseline(path: str) -> tuple[float, float, float]:
    """-> (b_p, b_r, b_f) for NLGEvaluator(bertscore_baseline=...)."""
    import json

    with open(path) as f:
        b = json.load(f)
    return (float(b["precision"]), float(b["recall"]), float(b["f1"]))


def make_bert_embed_fn(bert_params, bert_cfg, tokenizer, max_length: int = 128,
                       device="cuda") -> Callable:
    """Production embed_fn: the port's ``BertEncoder`` hidden states + mask +
    token ids (the triple NLGEvaluator/use_idf consume).  ``bert_params`` is
    ctpa's {'params': ...} tree (e.g. from ``data/hf_import.import_bert``),
    carried onto an encoder on ``device`` in fp32.  A call tokenizes on the
    host, runs the encoder once and reads its hidden states back once; the
    mask and ids are the tokenizer's (int32)."""
    import torch

    from ctpa_torch.convert import load_flax_params
    from ctpa_torch.models.bert import BertEncoder

    encoder = load_flax_params(BertEncoder(bert_cfg, device=device), bert_params["params"])
    encoder.eval()

    def embed(texts: Sequence[str]):
        toks = tokenizer(list(texts), max_length=max_length)
        ids, mask = toks["input_ids"], toks["attention_mask"]
        with torch.no_grad():
            hidden, _ = encoder(torch.as_tensor(ids, device=device).long(),
                                torch.as_tensor(mask, device=device))
        return hidden.float().cpu().numpy(), mask, ids

    return embed


# ---------------------------------------------------------------- suite


def simple_tokenize(text: str) -> list[str]:
    return text.lower().split()


class NLGEvaluator:
    """Batch metric suite (evaluation_module.py:17-224 capability).

    embed_fn: optional callable (list[str]) -> (embeddings (b, n, d),
    mask (b, n)) — or (embeddings, mask, token_ids (b, n)) when IDF weighting
    is wanted — for BERTScore; None skips it.

    bertscore_baseline: optional (b_p, b_r, b_f) rescaling constants.  The
    reference runs BERTScorer(rescale_with_baseline=True)
    (evaluation_module.py:53); the bert_score package ships those constants
    per (lang, model) — pass the matching triple here (for roberta-large/en
    the shipped first-layer-agnostic baseline is ~(0.83, 0.83, 0.83); with a
    custom encoder, compute a baseline by scoring random sentence pairs).

    use_idf: weight BERTScore by reference-corpus IDF (needs embed_fn to
    return token ids)."""

    def __init__(self, embed_fn: Optional[Callable] = None,
                 tokenize: Callable = simple_tokenize,
                 bertscore_baseline: Optional[Sequence[float]] = None,
                 use_idf: bool = False):
        self.embed_fn = embed_fn
        self.tokenize = tokenize
        self.bertscore_baseline = bertscore_baseline
        self.use_idf = use_idf

    def evaluate(self, references: Sequence[str], hypotheses: Sequence[str]) -> dict:
        assert len(references) == len(hypotheses)
        agg: dict[str, list[float]] = {}

        def add(k, v):
            agg.setdefault(k, []).append(v)

        for ref, hyp in zip(references, hypotheses):
            rt, ht = self.tokenize(ref), self.tokenize(hyp)
            add("bleu1", bleu(rt, ht, max_n=1))
            add("bleu4", bleu(rt, ht, max_n=4))
            r1 = rouge_n(rt, ht, 1)
            r2 = rouge_n(rt, ht, 2)
            rl = rouge_l(rt, ht)
            add("rouge1_f", r1["f1"]); add("rouge1_p", r1["precision"]); add("rouge1_r", r1["recall"])
            add("rouge2_f", r2["f1"])
            add("rougeL_f", rl["f1"]); add("rougeL_p", rl["precision"]); add("rougeL_r", rl["recall"])
            add("perfect_match", float(ref.strip().lower() == hyp.strip().lower()))

        if self.embed_fn is not None:
            rout = self.embed_fn(list(references))
            hout = self.embed_fn(list(hypotheses))
            re_, rm = rout[0], rout[1]
            he, hm = hout[0], hout[1]
            rids = rout[2] if len(rout) > 2 else None
            hids = hout[2] if len(hout) > 2 else None
            idf = None
            if self.use_idf:
                if rids is None:
                    raise ValueError(
                        "use_idf requires embed_fn to return (emb, mask, ids)")
                # IDF over reference corpus (BERTScore paper §3 / bert_score
                # get_idf_dict computes df over the reference sentences)
                corpus = [
                    [int(t) for t, m in zip(np.asarray(rids[i]), np.asarray(rm[i])) if m]
                    for i in range(len(references))
                ]
                idf = compute_idf(corpus)

            def weights(ids_row, idf_dict):
                if idf_dict is None or ids_row is None:
                    return None
                d = idf_dict["__default__"]
                return np.asarray([idf_dict.get(int(t), d) for t in np.asarray(ids_row)])

            for i in range(len(references)):
                bs = bert_score(
                    np.asarray(re_[i]), np.asarray(rm[i]),
                    np.asarray(he[i]), np.asarray(hm[i]),
                    ref_idf=weights(rids[i] if rids is not None else None, idf),
                    hyp_idf=weights(hids[i] if hids is not None else None, idf),
                    baseline=self.bertscore_baseline,
                )
                add("bertscore_p", bs["precision"])
                add("bertscore_r", bs["recall"])
                add("bertscore_f1", bs["f1"])

        out = {k: float(np.mean(v)) for k, v in agg.items()}
        # composite validation score (train_module.py:189-214)
        out["composite"] = (out.get("rougeL_f", 0.0) + out.get("bertscore_f1", out.get("rougeL_f", 0.0))) / 2
        return out
