"""Report-generation / VQA fine-tuning CLI (port of ``ctpa/cli/train_report.py``):
a frozen CT-CLIP vision trunk and a Meditron-class LLM with LoRA and a
cross-attention head, two-learning-rate AdamW with OneCycle, NLG
evaluation after each epoch, best-by-loss and best-by-val checkpoints.

    python -m ctpa_torch.cli.train_report --train-jsonl T.jsonl [--val-jsonl V.jsonl]
        [--mode report|vqa] [--llm-weights HF_SNAPSHOT] [--flash-prefill] [--tiny] ...

With ``--tiny`` the model is the tiny configuration in fp32 and each step
differentiates the whole tree (``make_report_train_step``); otherwise it is
Meditron-7B computing in bf16, whose frozen base is stored in bf16 and whose
trainable tensors (LoRA, cross-attention) and their AdamW moments are fp32
(``make_partitioned_report_step``: gradients for the trainable tensors only;
ctpa keeps the base in fp32 and casts it to bf16 at every use, which gives
the same operands).  ``--flash-prefill`` runs each 512-token training
forward through the flash kernels (K2 with its logsumexp, K3 for the
backward).  The weights start from a seed (``init_params``) unless
``--llm-weights`` names a local HF llama snapshot, which is grafted onto the
LLM (BF16 shards widened to fp32 on the host, each dropped once it is
copied).

The checkpoints hold the trained tensors; the frozen base is written once,
as ``<checkpoint-dir>/base.pt`` (``core/checkpoint.py:save_base``), for
``cli/generate_report.py`` and ``cli/export_serving.py``.  The command line
runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ctpa_torch.core.checkpoint import save_base
from ctpa_torch.core.config import CTViTConfig, LLMConfig, LoRAConfig, ReportGenConfig, TrainConfig
from ctpa_torch.core.init import random_init_
from ctpa_torch.data.datasets import ReportGenDataset, VQADataset
from ctpa_torch.data.tokenizer import HFTokenizer, SimpleWordTokenizer
from ctpa_torch.eval.nlg import NLGEvaluator
from ctpa_torch.models.layers import set_compute_dtype
from ctpa_torch.models.report_generator import CTReportGenerator
from ctpa_torch.train.report_trainer import (ReportTrainer, make_partitioned_report_step,
                                             make_report_optimizer, trainable_labels)
from ctpa_torch.train.train_state import SimpleTrainState


def collate_report(items, tokenizer, max_length):
    """Host batch: the items' volumes as (b, 1, ...) fp32 videos and the
    tokens of "prompt report" (or "question answer")."""
    texts = [f"{it['prompt']} {it['report']}" if "report" in it
             else f"{it['question']} {it['answer']}" for it in items]
    toks = tokenizer(texts, max_length=max_length)
    return {
        "video": np.stack([it["volume"] for it in items])[:, None].astype(np.float32),
        "input_ids": toks["input_ids"],
        "attention_mask": toks["attention_mask"],
    }


@torch.no_grad()
def init_params(model: CTReportGenerator, seed: int = 0) -> CTReportGenerator:
    """Seeded starting weights: ``core/init.py:random_init_`` for the base
    and the cross-attention, then ctpa's LoRA initializers (A ~ N(0,
    1/rank), B zero, so a fresh adapter is the identity)."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    random_init_(model, gen)
    for name, p in model.named_parameters():
        if name.endswith("lora_a"):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) / p.shape[1])
        elif name.endswith("lora_b"):
            p.zero_()
    return model


def build_model(llm_cfg: LLMConfig, vit_cfg: CTViTConfig, gen_cfg: ReportGenConfig,
                lora: LoRAConfig, tiny: bool, device) -> CTReportGenerator:
    """The CLI's model, seeded: fp32 with ``tiny``; else the base in bf16,
    the trainable tensors fp32, computing in bf16."""
    if tiny:
        return init_params(CTReportGenerator(llm_cfg, vit_cfg, gen_cfg, lora=lora,
                                             device=device))
    model = init_params(CTReportGenerator(llm_cfg, vit_cfg, gen_cfg, lora=lora, device=device,
                                          dtype=torch.bfloat16))
    labels = trainable_labels(model)
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            p.data = p.data.float()
    return set_compute_dtype(model, torch.bfloat16)


def make_eval_fn(model: CTReportGenerator, tokenizer, val_ds, gen_cfg: ReportGenConfig,
                 max_items: int = 16):
    """The validation scores of ``ReportTrainer``: greedy generation of 64
    tokens for up to ``max_items`` items, each prompted with its own
    "prompt report" text cut to ``gen_cfg.max_prompt_len`` tokens (ctpa's
    rule), through ``NLGEvaluator``."""

    def eval_fn(state):
        if val_ds is None:
            return {}
        dev = next(model.parameters()).device
        refs, hyps = [], []
        for i in range(min(len(val_ds), max_items)):
            item = val_ds[i]
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     collate_report([item], tokenizer, gen_cfg.max_prompt_len).items()}
            res = model.generate(batch["video"], batch["input_ids"], batch["attention_mask"], 64,
                                 eos_token_id=tokenizer.sep_token_id or 2, greedy=True)
            hyps.append(tokenizer.decode(res.tokens[0].tolist()))
            refs.append(item.get("report", item.get("answer", "")))
        return NLGEvaluator().evaluate(refs, hyps)

    return eval_fn


def make_loader(train_ds, tokenizer, batch_size: int, max_length: int):
    """A function giving one epoch of batches, ctpa's order (a permutation
    from seed 0, the same every epoch, the last partial batch dropped)."""

    def loader():
        order = np.random.default_rng(0).permutation(len(train_ds))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [train_ds[int(j)] for j in order[i:i + batch_size]]
            yield collate_report(items, tokenizer, max_length)

    return loader


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-jsonl", required=True)
    p.add_argument("--val-jsonl", default=None)
    p.add_argument("--mode", default="report", choices=["report", "vqa"])
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--llm-weights", default=None, help="local HF llama snapshot dir")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--lora-rank", type=int, default=16)
    p.add_argument("--lora-alpha", type=float, default=32.0)
    p.add_argument("--results-dir", default="report_results")
    p.add_argument("--checkpoint-dir", default="report_checkpoints")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--flash-prefill", action="store_true",
                   help="run the full training forward through the flash kernels "
                        "(needs max-length >= 512)")
    return p


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    if args.tiny:
        llm_cfg, vit_cfg = LLMConfig.tiny(), CTViTConfig.tiny()
    else:
        llm_cfg, vit_cfg = LLMConfig(), CTViTConfig()
    if args.flash_prefill:
        llm_cfg = dataclasses.replace(llm_cfg, flash_prefill=True)
    lora = LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha)
    gen_cfg = ReportGenConfig(lora=lora)
    model = build_model(llm_cfg, vit_cfg, gen_cfg, lora, args.tiny, device)
    tokenizer = HFTokenizer(args.tokenizer) if args.tokenizer else SimpleWordTokenizer(
        vocab_size=llm_cfg.vocab_size, max_length=args.max_length)

    ds_cls = ReportGenDataset if args.mode == "report" else VQADataset
    train_ds = ds_cls(args.train_jsonl)
    val_ds = ds_cls(args.val_jsonl) if args.val_jsonl else None
    print(f"train: {len(train_ds)} samples", file=sys.stderr)

    if args.llm_weights:
        from ctpa_torch.convert import overlay_flax_params
        from ctpa_torch.data.hf_import import import_llama, load_hf_snapshot

        overlay_flax_params(model.llm, import_llama(load_hf_snapshot(args.llm_weights), llm_cfg))
        print("loaded LLM weights from", args.llm_weights, file=sys.stderr)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.epochs
    if args.tiny:
        tx, step_fn = make_report_optimizer(model, gen_cfg, total_steps=total_steps), None
    else:
        # gradients only for the trainable tensors: a full-tree gradient at 7B
        # is another 13.5 GB
        step_fn, tx = make_partitioned_report_step(model, gen_cfg, total_steps=total_steps)
    state = SimpleTrainState.create(model, tx)
    trainer = ReportTrainer(
        model, state, tx,
        cfg=TrainConfig(results_dir=args.results_dir, checkpoint_dir=args.checkpoint_dir),
        eval_fn=make_eval_fn(model, tokenizer, val_ds, gen_cfg), step_fn=step_fn)
    save_base(args.checkpoint_dir, state.frozen_state_dict())

    loader = make_loader(train_ds, tokenizer, args.batch_size, args.max_length)
    for epoch in range(args.epochs):
        out = trainer.train_epoch(loader(), epoch)
        print(f"epoch {epoch}: {out}", file=sys.stderr)
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
