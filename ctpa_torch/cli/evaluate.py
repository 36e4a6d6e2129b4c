"""Standalone evaluation CLI (port of ``ctpa/cli/evaluate.py``, without
pandas): given a results JSON/CSV of (reference, prediction) pairs, or
zero-shot predictions and labels npz files, compute the metric suites and
write the artifact files.

    python -m ctpa_torch.cli.evaluate nlg --results R.json [--encoder-path SNAPSHOT
        [--idf] [--baseline B.json]]
    python -m ctpa_torch.cli.evaluate nlg --compute-baseline --encoder-path SNAPSHOT
        --corpus C.txt [--baseline-out B.json]
    python -m ctpa_torch.cli.evaluate classification --predictions P.npz --labels L.npz
        [--out-csv aurocs.csv] [--plot-dir D] [--bootstrap N]

``nlg`` reads a CSV through ``data/manifests.read_csv`` (pandas' typing);
its BERTScore embeddings come from a local HF BERT snapshot
(``data/hf_import``, BF16 shards included) through the port's
``BertEncoder`` on the card, or on the device ``main`` is given.
``classification`` prints the AUROC table as pandas' ``to_json()`` prints
it and writes ctpa's three CSVs byte for byte.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ctpa_torch.data.manifests import read_csv, write_csv
from ctpa_torch.eval.classification import (accuracy_f1_at_youden, bootstrap_cis,
                                            evaluate_classification, table_json, table_rows)
from ctpa_torch.eval.nlg import (NLGEvaluator, compute_bertscore_baseline,
                                 load_bertscore_baseline, save_bertscore_baseline)
from ctpa_torch.eval.zeroshot import PATHOLOGIES


def _build_embed_fn(encoder_path: str, device):
    """Local HF BERT snapshot -> NLGEvaluator embed_fn (eval/nlg.py)."""
    from ctpa_torch.core.config import BertConfig
    from ctpa_torch.data.hf_import import import_bert, load_hf_snapshot
    from ctpa_torch.data.tokenizer import HFTokenizer
    from ctpa_torch.eval.nlg import make_bert_embed_fn

    cfg = BertConfig()
    sd = load_hf_snapshot(encoder_path)
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    params = {"params": import_bert(sd, cfg, prefix=prefix)}
    del sd
    return make_bert_embed_fn(params, cfg, HFTokenizer(encoder_path), device=device)


def eval_nlg(args, device="cuda") -> int:
    embed_fn = _build_embed_fn(args.encoder_path, device) if args.encoder_path else None

    if args.compute_baseline:
        # the random-pair scores of this encoder over the corpus (the
        # reference's rescale_with_baseline for a custom encoder)
        if embed_fn is None:
            raise SystemExit("--compute-baseline requires --encoder-path")
        if not (args.corpus or args.results):
            raise SystemExit("--compute-baseline requires --corpus (or --results)")
        with open(args.corpus or args.results) as f:
            corpus = [line.strip() for line in f if line.strip()]
        baseline = compute_bertscore_baseline(embed_fn, corpus, use_idf=args.idf)
        save_bertscore_baseline(args.baseline_out, baseline)
        print(json.dumps(baseline, indent=2))
        return 0

    if not args.results:
        raise SystemExit("--results is required unless --compute-baseline")
    if args.idf and embed_fn is None:
        raise SystemExit("--idf requires --encoder-path (BERTScore embeddings)")
    if args.results.endswith(".json"):
        with open(args.results) as f:
            payload = json.load(f)
        records = payload.get("samples", payload)
    else:
        records = read_csv(args.results).rows
    refs = [str(r[args.reference_col]) for r in records]
    hyps = [str(r[args.prediction_col]) for r in records]
    baseline = load_bertscore_baseline(args.baseline) if args.baseline else None
    metrics = NLGEvaluator(embed_fn=embed_fn, bertscore_baseline=baseline,
                           use_idf=args.idf).evaluate(refs, hyps)
    print(json.dumps({k: round(v, 6) for k, v in metrics.items()}, indent=2))
    return 0


def eval_classification(args) -> int:
    preds = np.load(args.predictions)["data"]
    labels = np.load(args.labels)["data"]
    names = list(PATHOLOGIES)[: preds.shape[1]]
    aurocs = evaluate_classification(preds, labels, names, plot_dir=args.plot_dir)
    cis = bootstrap_cis(preds, labels, names, n_samples=args.bootstrap)
    ops = accuracy_f1_at_youden(preds, labels, names)
    print(table_json(aurocs), file=sys.stdout)
    if args.out_csv:
        for suffix, table in ((".csv", aurocs), ("_cis.csv", cis), ("_operating.csv", ops)):
            write_csv(args.out_csv.replace(".csv", suffix), table_rows(table), list(table))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="task", required=True)

    n = sub.add_parser("nlg", help="BLEU/ROUGE/BERTScore over reference/prediction pairs")
    n.add_argument("--results", required=False, default=None,
                   help="results JSON or CSV")
    n.add_argument("--reference-col", default="reference")
    n.add_argument("--prediction-col", default="prediction")
    n.add_argument("--encoder-path", default=None,
                   help="local HF BERT snapshot for BERTScore embeddings")
    n.add_argument("--baseline", default=None,
                   help="BERTScore baseline JSON (from --compute-baseline)")
    n.add_argument("--idf", action="store_true",
                   help="IDF-weight BERTScore over the reference corpus")
    n.add_argument("--compute-baseline", action="store_true",
                   help="compute + store random-pair BERTScore baseline "
                        "constants for the encoder instead of evaluating")
    n.add_argument("--corpus", default=None,
                   help="text file (one sentence/line) for --compute-baseline")
    n.add_argument("--baseline-out", default="bertscore_baseline.json")

    c = sub.add_parser("classification", help="AUROC/ROC/bootstrap over zero-shot outputs")
    c.add_argument("--predictions", required=True, help="predicted_weights.npz")
    c.add_argument("--labels", required=True, help="labels_weights.npz")
    c.add_argument("--plot-dir", default=None)
    c.add_argument("--bootstrap", type=int, default=1000)
    c.add_argument("--out-csv", default=None)
    return p


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    return eval_nlg(args, device) if args.task == "nlg" else eval_classification(args)


if __name__ == "__main__":
    sys.exit(main())
