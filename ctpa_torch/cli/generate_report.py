"""Report-generation / VQA inference CLI (port of ``ctpa/cli/generate_report.py``):
restore the latest report checkpoint (or load a serving bundle), preprocess
each scan on the device, decode with the KV-cached continuous batcher, and
write the JSON/CSV results with their NLG metrics, and optionally per-sample
tri-plane visualizations.  The cross-attention conditioning is always on.

    python -m ctpa_torch.cli.generate_report --jsonl D.jsonl --checkpoint-dir CKPT
        [--greedy] [--speculative K | --spec-serve K] [--quant int8|int4 [--act-quant]]
    python -m ctpa_torch.cli.generate_report --jsonl D.jsonl --serving-bundle BUNDLE ...

A checkpoint directory holds the trained tensors of each step and, once, the
frozen base they were trained on (``base.pt``, written by
``cli/train_report.py``); the model is the base with the latest step's
tensors over it.  A directory without its base raises, naming the file.

The float model computes in fp32, as ctpa's.  The quantized models (a
serving bundle, or ``--quant`` on a checkpoint) compute in bf16
(``QUANT_COMPUTE_DTYPE``), the activations the port's int8 and int4 kernels
(K4-K7) take; a bundle written with ``--flash-decode`` runs the
decode-attention kernel (K8).  The command line runs on the card;
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ctpa_torch.cli.export_serving import BUNDLE_KIND, load_serving_bundle
from ctpa_torch.core.checkpoint import CheckpointManager, load_base
from ctpa_torch.core.config import (CTViTConfig, LLMConfig, LoRAConfig, PreprocessConfig,
                                    ReportGenConfig)
from ctpa_torch.data.datasets import ReportGenDataset, VQADataset
from ctpa_torch.data.tokenizer import HFTokenizer, SimpleWordTokenizer
from ctpa_torch.eval.artifacts import visualize_sample, write_nlg_results
from ctpa_torch.eval.nlg import NLGEvaluator
from ctpa_torch.models.layers import set_compute_dtype
from ctpa_torch.models.report_generator import CTReportGenerator
from ctpa_torch.ops.preprocess import preprocess_volume_inference
from ctpa_torch.pipelines.streaming import ContinuousBatcher, Request

# the compute dtype of the quantized models: the port's K4-K7 take bf16
# activations only
QUANT_COMPUTE_DTYPE = torch.bfloat16


@torch.no_grad()
def generate_responses(
    model: CTReportGenerator,
    tokenizer,
    items: list[dict],
    pre_cfg: PreprocessConfig,
    max_new_tokens: int = 128,
    num_lanes: int = 4,
    prompt_len: int = 64,
    temperature: float = 0.7,
    greedy: bool = False,
    spec_lookup: int = 0,
    spec_serve: int = 0,
    visualize_dir: str | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
) -> list[dict]:
    """Batched KV-cached generation over dataset items on the model's device.

    ``spec_lookup > 0`` is the latency tier: one request at a time through
    prompt-lookup speculative decoding with that many draft tokens
    (``CTReportGenerator.generate_speculative``; token-exact under
    ``greedy``, distribution-exact under sampling), item i drawing from a
    generator seeded with i (ctpa folds i into key 0).  ``spec_serve > 0``
    keeps the batched path and speculates inside the batcher
    (``ContinuousBatcher(spec_lookup=...)``, the same exactness)."""
    dev = next(model.parameters()).device
    eos = tokenizer.sep_token_id or 2
    if spec_lookup:
        records = []
        for i, item in enumerate(items):
            video = preprocess_volume_inference(item["volume"], cfg=pre_cfg, device=dev)
            prompt = item.get("prompt", item.get("question", ""))
            toks = tokenizer([prompt], max_length=prompt_len)
            t0 = time.time()
            r = model.generate_speculative(
                video[None].float(), torch.as_tensor(toks["input_ids"][:1], device=dev).long(),
                torch.as_tensor(toks["attention_mask"][:1], device=dev), max_new_tokens,
                eos_token_id=eos, draft_len=spec_lookup, greedy=greedy,
                temperature=temperature, top_k=top_k, top_p=top_p,
                generator=torch.Generator(device=dev).manual_seed(i))
            n_tok = int(r.lengths[0])
            records.append({
                "id": i,
                "prompt": prompt,
                "reference": item.get("report", item.get("answer", "")),
                "prediction": tokenizer.decode(r.tokens[0, :n_tok].tolist()),
                "tokens": n_tok,
                "latency_s": round(time.time() - t0, 4),
                "verify_steps": int(r.steps),
            })
        return records

    batcher = ContinuousBatcher(
        model, num_lanes=num_lanes,
        max_len=prompt_len + max_new_tokens + max(8, spec_serve + 1),
        eos_token_id=eos, temperature=temperature, greedy=greedy,
        top_k=top_k, top_p=top_p, spec_lookup=spec_serve or None)
    for i, item in enumerate(items):
        video = preprocess_volume_inference(item["volume"], cfg=pre_cfg, device=dev)
        vision = model.extract_vision(video[None].float())[0]
        prompt = item.get("prompt", item.get("question", ""))
        toks = tokenizer([prompt], max_length=prompt_len)
        batcher.submit(Request(
            request_id=i, input_ids=toks["input_ids"][0],
            attention_mask=toks["attention_mask"][0], vision=vision,
            max_new_tokens=max_new_tokens))
        batcher.step()
        if visualize_dir:
            visualize_sample(visualize_dir, video.cpu().numpy(), prompt,
                             item.get("report", item.get("answer", "")), "(pending)",
                             f"sample_{i}")
    results = batcher.run_until_done()
    return [{
        "id": i,
        "prompt": item.get("prompt", item.get("question", "")),
        "reference": item.get("report", item.get("answer", "")),
        "prediction": tokenizer.decode(results[i].tokens),
        "tokens": len(results[i].tokens),
        "latency_s": round(results[i].latency_s, 4),
    } for i, item in enumerate(items)]


@torch.no_grad()
def quantized_model(params: dict, llm_cfg: LLMConfig, vit_cfg: CTViTConfig,
                    gen_cfg: ReportGenConfig, lora: LoRAConfig | None) -> CTReportGenerator:
    """The ``--quant`` model of a checkpoint's tensors (its base and a step
    over it) on their device: the LoRA deltas merged into the base weights
    and the projections quantized as ``llm_cfg.weight_quant`` says
    (``quantize_tree``), so the model carries no adapters; it computes in
    ``QUANT_COMPUTE_DTYPE``."""
    from ctpa_torch.ops.quant import quantize_tree

    params = quantize_tree(params, lora=lora, bits=4 if llm_cfg.weight_quant == "int4" else 8)
    model = CTReportGenerator(llm_cfg, vit_cfg, gen_cfg, device="meta")
    model.load_state_dict(params, assign=True)
    return set_compute_dtype(model, QUANT_COMPUTE_DTYPE)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--jsonl", required=True, help="dataset manifest")
    p.add_argument("--mode", default="report", choices=["report", "vqa"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="training checkpoints (or pass --serving-bundle)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--out-dir", default="generation_results")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--num-lanes", type=int, default=4)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=0,
                   help="sample from the k highest-probability tokens (0 = off)")
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling: smallest token set with cumulative probability "
                        ">= p (0 = off)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="latency tier: prompt-lookup speculative decoding with K draft "
                        "tokens, one request at a time — token-exact under --greedy, "
                        "distribution-exact under sampling (rejection-sampling acceptance)")
    p.add_argument("--spec-serve", type=int, default=0, metavar="K",
                   help="throughput tier: speculative verify chunks INSIDE the continuous "
                        "batcher (same exactness as --speculative)")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--quant", choices=["none", "int8", "int4"], default="none",
                   help="weight-only serving quantization of the LLM (ops/quant.py): int8 "
                        "~halves the weight memory; int4 halves it again (group-128 scales)")
    p.add_argument("--serving-bundle", default=None, metavar="DIR",
                   help="load a pre-quantized bundle written by cli/export_serving.py instead "
                        "of a training checkpoint; the bundle's metadata sets the serving "
                        "config")
    p.add_argument("--act-quant", action="store_true",
                   help="with --quant int8: w8a8 — per-token int8 activations, int8 dots "
                        "(quant_act)")
    p.add_argument("--quant-impl", choices=["pallas", "xla"], default="pallas",
                   help="quantized-matmul backend: the hand-written kernels on the card "
                        "(their plain versions on CPU tensors), or ctpa's plain composition")
    p.add_argument("--lora-rank", type=int, default=16,
                   help="LoRA rank the checkpoint was trained with (0 = no LoRA); must match "
                        "cli/train_report.py")
    p.add_argument("--lora-alpha", type=float, default=32.0)
    return p


def main(argv=None, device="cuda") -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.act_quant and args.quant == "none":
        p.error("--act-quant requires quantized weights (--quant int8 -> "
                "w8a8, --quant int4 -> w4a8)")
    if args.spec_serve and args.speculative:
        p.error("pass at most one of --speculative (latency tier) / "
                "--spec-serve (throughput tier)")
    if bool(args.serving_bundle) == bool(args.checkpoint_dir):
        p.error("pass exactly one of --checkpoint-dir / --serving-bundle")
    if args.serving_bundle and (args.quant != "none" or args.act_quant):
        p.error("--serving-bundle already fixes the quantization config; "
                "drop --quant/--act-quant")

    if args.serving_bundle:
        meta = CheckpointManager(args.serving_bundle).restore_metadata()
        if not meta or meta.get("kind") != BUNDLE_KIND:
            p.error(f"{args.serving_bundle} is not a serving bundle "
                    "(write one with cli/export_serving.py)")

    if args.tiny:
        llm_cfg, vit_cfg = LLMConfig.tiny(), CTViTConfig.tiny()
    else:
        llm_cfg, vit_cfg = LLMConfig(), CTViTConfig()
    lora = (LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha)
            if args.lora_rank > 0 else None)
    gen_cfg = ReportGenConfig()
    tokenizer = (HFTokenizer(args.tokenizer) if args.tokenizer
                 else SimpleWordTokenizer(vocab_size=llm_cfg.vocab_size))

    if args.serving_bundle:
        # the bundle stores the quantized tensors and its serving config
        model, _ = load_serving_bundle(args.serving_bundle, llm_cfg, vit_cfg, gen_cfg,
                                       quant_impl=args.quant_impl, dtype=QUANT_COMPUTE_DTYPE,
                                       device=device)
    else:
        state = CheckpointManager(args.checkpoint_dir).restore(map_location=device)
        if state is None:
            print("no checkpoint found", file=sys.stderr)
            return 1
        params = load_base(args.checkpoint_dir, map_location=device)
        params.update(state["params"])
        del state
        if args.quant == "none":
            model = CTReportGenerator(llm_cfg, vit_cfg, gen_cfg, lora=lora, device=device)
            model.load_state_dict(params)
        else:
            llm_cfg = dataclasses.replace(llm_cfg, weight_quant=args.quant,
                                          quant_act=args.act_quant, quant_impl=args.quant_impl)
            model = quantized_model(params, llm_cfg, vit_cfg, gen_cfg, lora)
        del params
    model.eval()

    ds = (ReportGenDataset if args.mode == "report" else VQADataset)(args.jsonl)
    n = min(len(ds), args.max_samples) if args.max_samples else len(ds)
    items = [ds[i] for i in range(n)]
    pre_cfg = PreprocessConfig.inference() if not args.tiny else PreprocessConfig(
        target_shape=(vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size))

    records = generate_responses(
        model, tokenizer, items, pre_cfg,
        max_new_tokens=args.max_new_tokens, num_lanes=args.num_lanes,
        temperature=args.temperature, greedy=args.greedy,
        top_k=args.top_k or None, top_p=args.top_p or None,
        spec_lookup=args.speculative, spec_serve=args.spec_serve,
        visualize_dir=f"{args.out_dir}/viz" if args.visualize else None)

    metrics = NLGEvaluator().evaluate(
        [r["reference"] for r in records], [r["prediction"] for r in records])
    paths = write_nlg_results(args.out_dir, records, metrics)
    print({"n": len(records), **{k: round(v, 4) for k, v in metrics.items()}},
          file=sys.stderr)
    print("wrote:", paths, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
