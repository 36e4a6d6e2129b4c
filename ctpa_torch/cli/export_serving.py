"""Export a serving bundle (port of ``ctpa/cli/export_serving.py``): quantize
a trained report-generator checkpoint once, offline, and store the quantized
state with the serving configuration it was prepared for, so serving loads it
directly (``load_serving_bundle``) instead of quantizing at every start.

    python -m ctpa_torch.cli.export_serving --checkpoint-dir CKPT --out BUNDLE \\
        --quant int4 --ffn-kernel --act-quant --kv-quant int8 --flash-decode [--base BASE.pt]

The port's report checkpoints hold only the tensors the fine-tune trained
(LoRA adapters and cross-attention; ``train/train_state.py``:
``SimpleTrainState``); the frozen base, which ctpa writes into every
checkpoint, lies once beside them as ``CKPT/base.pt``
(``cli/train_report.py``; ``core/checkpoint.py:load_base``).  ``--base``
names another ``torch.save``d ``state_dict`` of the ``CTReportGenerator`` the
fine-tune started from, in its place.  The trained tensors replace their
entries, the LoRA deltas are merged, and the projections quantized
(``ops/quant.py:quantize_tree``), on ``--device`` (the card by default).
The bundle's metadata has ctpa's keys, so the loader cannot pair int4
weights with an int8 model or the other way round.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import torch

BUNDLE_KIND = "ctpa-serving-bundle"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True,
                   help="report-training checkpoints (the trained tensors only)")
    p.add_argument("--base", default=None,
                   help="torch.save'd state_dict of the CTReportGenerator the fine-tune "
                        "started from (default: the base.pt that train_report writes into "
                        "--checkpoint-dir; ctpa's checkpoints hold the base, so its export "
                        "has no such flag)")
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to export (default: latest)")
    p.add_argument("--quant", choices=["int8", "int4"], default="int8")
    p.add_argument("--ffn-kernel", action="store_true",
                   help="prepare for LLMConfig.quant_ffn_kernel serving (one fused FFN "
                        "launch per layer)")
    p.add_argument("--act-quant", action="store_true",
                   help="record w8a8/w4a8 serving intent (the weights are the same; stored "
                        "so the loader enables quant_act)")
    p.add_argument("--kv-quant", choices=["none", "int8", "int4"], default="none")
    p.add_argument("--flash-decode", action="store_true")
    p.add_argument("--lora-rank", type=int, default=16,
                   help="LoRA rank the checkpoint was trained with (0 = no LoRA); the deltas "
                        "are merged before quantization")
    p.add_argument("--lora-alpha", type=float, default=32.0)
    p.add_argument("--device", default="cuda", help="where the quantization runs")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ctpa_torch.core.checkpoint import CheckpointManager, load_base
    from ctpa_torch.core.config import LoRAConfig
    from ctpa_torch.ops.quant import quantize_tree

    mgr = CheckpointManager(args.checkpoint_dir)
    step = args.step if args.step is not None else mgr.latest_step()
    state = mgr.restore(step, map_location=args.device)
    if state is None:
        print("no checkpoint found", file=sys.stderr)
        return 1
    trained = state["params"] if isinstance(state, dict) and "params" in state else state
    full = (load_base(args.checkpoint_dir, map_location=args.device) if args.base is None
            else torch.load(args.base, map_location=args.device, weights_only=True, mmap=True))
    full.update(trained)
    lora = LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha) if args.lora_rank > 0 else None
    with torch.no_grad():
        params = quantize_tree(full, lora=lora, bits=4 if args.quant == "int4" else 8,
                               ffn_kernel=args.ffn_kernel)
    del full, trained, state
    meta = {
        "kind": BUNDLE_KIND,
        "weight_quant": args.quant,
        "quant_ffn_kernel": args.ffn_kernel,
        "quant_act": args.act_quant,
        "kv_quant": None if args.kv_quant == "none" else args.kv_quant,
        "flash_decode": args.flash_decode,
        "lora_merged": {"rank": args.lora_rank, "alpha": args.lora_alpha} if lora else None,
        "source_checkpoint": args.checkpoint_dir,
        "source_step": step,
    }
    CheckpointManager(args.out, max_to_keep=1).save(0, params, metadata=meta, force=True)
    print(f"serving bundle written to {args.out}: {meta}", file=sys.stderr)
    return 0


def load_serving_bundle(path: str, llm_cfg=None, vit_cfg=None, gen_cfg=None,
                        quant_impl: str = "pallas", dtype=torch.bfloat16,
                        device="cuda") -> tuple[torch.nn.Module, dict]:
    """The bundle half of ctpa's ``generate_report --serving-bundle``: read the
    metadata, set the ``LLMConfig`` serving settings from it (on ``llm_cfg``,
    Meditron-7B by default), build the ``CTReportGenerator`` and load the
    bundle's tensors as they are, computing in ``dtype``.  A directory that is
    not a bundle raises.  -> (model in eval mode, metadata)."""
    from ctpa_torch.core.checkpoint import CheckpointManager
    from ctpa_torch.core.config import CTViTConfig, LLMConfig, ReportGenConfig
    from ctpa_torch.models.layers import set_compute_dtype
    from ctpa_torch.models.report_generator import CTReportGenerator

    meta: Optional[dict] = None
    if os.path.isdir(path):
        meta = CheckpointManager(path).restore_metadata()
    if not meta or meta.get("kind") != BUNDLE_KIND:
        raise ValueError(f"{path} is not a serving bundle (write one with "
                         "ctpa_torch.cli.export_serving)")
    llm_cfg = dataclasses.replace(
        llm_cfg or LLMConfig(), weight_quant=meta["weight_quant"],
        quant_act=bool(meta.get("quant_act")), quant_impl=quant_impl,
        quant_ffn_kernel=bool(meta.get("quant_ffn_kernel")), kv_quant=meta.get("kv_quant"),
        flash_decode=bool(meta.get("flash_decode")))
    model = CTReportGenerator(llm_cfg, vit_cfg or CTViTConfig(), gen_cfg or ReportGenConfig(),
                              device="meta", dtype=dtype)
    state = CheckpointManager(path).restore(0, map_location=device)
    model.load_state_dict(state, strict=True, assign=True)
    return set_compute_dtype(model, dtype).eval(), meta


if __name__ == "__main__":
    sys.exit(main())
