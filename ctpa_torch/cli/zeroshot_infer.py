"""Zero-shot classification CLI — CTCLIP over a labeled inference set (port of
``ctpa/cli/zeroshot_infer.py``).

Encode each volume once, score all pathology prompt pairs from cached prompt
latents, write the npz/txt/csv artifacts and the AUROC/bootstrap
evaluation.  ``run_zeroshot`` takes any ``CTCLIP``: one built with
``pallas_patchify=True, flash_axial=True`` (``models.pretrained.build_ctclip``)
runs the patchify and flash kernels.  ``main`` restores this package's
checkpoint store (``CheckpointManager``, as ``CTClipTrainer.save`` writes it)
into the default config's fp32 model.

    python -m ctpa_torch.cli.zeroshot_infer --data-dir D --reports-csv R \\
        --labels-csv L --checkpoint-dir C [--out-dir O] [--tiny]

The command line runs on the card; ``main(argv, device="cpu")`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig, PreprocessConfig
from ctpa_torch.data.datasets import CTReportInferenceDataset
from ctpa_torch.data.manifests import write_csv
from ctpa_torch.data.tokenizer import HFTokenizer, SimpleWordTokenizer
from ctpa_torch.eval.artifacts import write_zeroshot_artifacts
from ctpa_torch.eval.classification import bootstrap_cis, evaluate_classification, table_rows
from ctpa_torch.eval.zeroshot import PATHOLOGIES, ZeroShotClassifier
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.ops.preprocess import preprocess_volume_inference
from ctpa_torch.ops.vq import VQState, vq_init


@torch.no_grad()
def run_zeroshot(
    model: CTCLIP,
    vq_state,
    dataset,
    tokenizer,
    out_dir: str,
    pathologies=PATHOLOGIES,
    pre_cfg: PreprocessConfig = PreprocessConfig.inference(),
    batch_size: int = 4,
) -> dict:
    """Score every volume of ``dataset`` on the model's device and write the
    evaluation to ``out_dir``; returns {"mean_auc", "n"}.  Videos are cast to
    the model's parameter dtype; the scores stay on the device until one
    read for the whole set."""
    param = next(model.parameters())
    device, dtype = param.device, param.dtype

    def tokenize(texts):
        out = tokenizer(texts)
        return (torch.as_tensor(out["input_ids"], device=device).long(),
                torch.as_tensor(out["attention_mask"], device=device))

    # exp of the fp32 log-temperature on the host, as ctpa's numpy does
    temp = float(np.exp(model.temperature.detach().float().cpu().numpy()))
    clf = ZeroShotClassifier(model.encode_text, tokenize, temp, pathologies)

    preds, reals, accs = [], [], []
    buf = []
    for i in range(len(dataset)):
        s = dataset[i]
        video = preprocess_volume_inference(s.volume, cfg=pre_cfg, device=device)
        buf.append((video, s.labels, s.accession))
        if len(buf) == batch_size or i == len(dataset) - 1:
            videos = torch.stack([b[0] for b in buf]).to(dtype)
            lat, _ = model.encode_image(videos, vq_state)
            preds.append(clf.score(lat))
            reals.extend([b[1] for b in buf])
            accs.extend([b[2] for b in buf])
            buf = []
    predictions = torch.cat(preds).cpu().numpy()
    labels = np.stack(reals)

    aurocs = evaluate_classification(predictions, labels, pathologies, plot_dir=out_dir)
    cis = bootstrap_cis(predictions, labels, pathologies, n_samples=500)
    write_zeroshot_artifacts(out_dir, predictions, labels, accs, aurocs)
    write_csv(f"{out_dir}/bootstrap_cis.csv", table_rows(cis), list(cis))
    return {"mean_auc": float(aurocs["mean_auc"][0]), "n": int(labels.shape[0])}


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--reports-csv", required=True)
    p.add_argument("--labels-csv", required=True)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--tokenizer", default=None, help="local HF tokenizer path")
    p.add_argument("--out-dir", default="zeroshot_results")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    args = p.parse_args(argv)

    if args.tiny:
        vit_cfg, bert_cfg = CTViTConfig.tiny(), BertConfig.tiny()
        clip_cfg = CTCLIPConfig.tiny(vit_cfg, bert_cfg)
    else:
        vit_cfg, bert_cfg, clip_cfg = CTViTConfig(), BertConfig(), CTCLIPConfig()

    from ctpa_torch.core.checkpoint import CheckpointManager

    state = CheckpointManager(args.checkpoint_dir).restore(map_location=device)
    if state is None:
        print("no checkpoint found", file=sys.stderr)
        return 1
    model = CTCLIP(clip_cfg, vit_cfg, bert_cfg, device=device).eval()
    model.load_state_dict(state["params"])
    if state.get("vq_state") is not None:
        vq_state = VQState(**{k: torch.as_tensor(v, device=device)
                              for k, v in state["vq_state"].items()})
    else:
        vq_state = vq_init(torch.Generator(device=device).manual_seed(0),
                           vit_cfg.codebook_size, vit_cfg.dim, device=device)

    tokenizer = (HFTokenizer(args.tokenizer) if args.tokenizer
                 else SimpleWordTokenizer(
                     vocab_size=bert_cfg.vocab_size,
                     max_length=min(512, bert_cfg.max_position_embeddings)))
    dataset = CTReportInferenceDataset(
        args.data_dir, args.reports_csv, args.labels_csv, PATHOLOGIES)
    pre_cfg = dataclasses.replace(
        PreprocessConfig.inference(),
        target_shape=(vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size))
    summary = run_zeroshot(model, vq_state, dataset, tokenizer, args.out_dir,
                           pre_cfg=pre_cfg, batch_size=args.batch_size)
    print(summary, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
