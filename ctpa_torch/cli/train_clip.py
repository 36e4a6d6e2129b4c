"""CT-CLIP contrastive training CLI (port of ``ctpa/cli/train_clip.py``):
the dataset of raw volumes and reports, the prefetching loader with the
preprocessing on the device, wd-grouped AdamW with cosine warm-up restarts,
``CTClipTrainer`` with periodic zero-shot evaluation and checkpoints.

    python -m ctpa_torch.cli.train_clip --data-dir D --reports-csv R
        [--metadata-csv M] [--valid-data-dir V --valid-labels-csv L]
        [--eval-every N] [--batch-size B] [--num-steps S] [--resume]
        [--profile-dir P] [--tiny] ...

As ctpa's CLI, the model is an fp32 CTCLIP trained under the bf16 policy:
the video is rounded to bf16, the towers compute in fp32.  At full width
the spatial fold's attention runs through the flash kernels (K2 with its
logsumexp, K3 for the backward) wherever the device is not the CPU;
``--tiny`` takes the tiny configurations.  The command line runs on the
card; ``main(argv, device="cpu")`` runs on the CPU.

Multi-process training, one process per card (on one host or several):

    python -m ctpa_torch.cli.train_clip ... --coordinator HOST:PORT \
        --num-processes P --process-id I

on every process (I = 0 .. P-1; HOST:PORT is where process 0 listens; a
``file:///path`` URL on a shared file system works as well).  Each process
reads a disjoint ``ProcessShard`` of the dataset, ``--batch-size`` is the
global batch (it must divide by P), the step is the global batch's
(``train/clip_trainer.py``), and only process 0 evaluates and writes
checkpoints.  On the card the group is NCCL, on the CPU gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys

import torch

from ctpa_torch.core.config import (BertConfig, CTCLIPConfig, CTViTConfig, OptimizerConfig,
                                    PreprocessConfig, TrainConfig)
from ctpa_torch.core.init import random_init_
from ctpa_torch.core.mesh import batch_sharding, create_mesh, initialize_distributed, process_count
from ctpa_torch.core.profiling import trace
from ctpa_torch.data.datasets import (CTReportDataset, ProcessShard, batch_iterator,
                                     collate_clip)
from ctpa_torch.data.prefetch import PrefetchIterator, to_device
from ctpa_torch.data.tokenizer import HFTokenizer, SimpleWordTokenizer
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.ops.preprocess import preprocess_batch
from ctpa_torch.ops.vq import VQState, vq_init
from ctpa_torch.train.clip_trainer import CTClipTrainer
from ctpa_torch.train.optim import get_optimizer
from ctpa_torch.train.train_state import CLIPTrainState


def build_loader(dataset, tokenizer, batch_size: int, pre_cfg: PreprocessConfig, device,
                 max_length: int = 512, preprocessed: bool = False,
                 process_local: bool = False, mesh=None) -> PrefetchIterator:
    """Batches of {"input_ids", "attention_mask", "video"} on ``device``,
    prepared ahead on the prefetcher's thread: the raw volumes go to the
    device and are preprocessed there (``preprocessed``: they are on the
    canonical grid already).  ``process_local`` (with ``mesh``): the
    dataset is this process's shard and ``batch_size`` its rows."""
    raw_iter = batch_iterator(dataset, batch_size,
                              lambda s: collate_clip(s, tokenizer, max_length))

    def device_side():
        for batch in raw_iter:
            video = to_device(batch["video"], device)
            if preprocessed:
                video = video[:, None]
            else:
                video = preprocess_batch(video, batch["slope"], batch["intercept"],
                                         batch["spacing"], cfg=pre_cfg, device=device)
            yield {"input_ids": batch["input_ids"], "attention_mask": batch["attention_mask"],
                   "video": video}

    sharding = None if mesh is None else batch_sharding(mesh)
    return PrefetchIterator(device_side(), device=device, sharding=sharding,
                            process_local=process_local)


@torch.no_grad()
def init_state(model: CTCLIP, seed: int = 0) -> tuple[CTCLIP, VQState]:
    """Seeded starting weights (``core/init.py:random_init_``) and VQ
    codebook (``ops/vq.py:vq_init``), on the model's device."""
    device = model.temperature.device
    gen = torch.Generator(device=device).manual_seed(seed)
    random_init_(model, gen)
    cfg = model.visual_transformer.cfg
    return model, vq_init(gen, cfg.codebook_size, cfg.dim, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--reports-csv", required=True)
    p.add_argument("--metadata-csv", default=None)
    p.add_argument("--valid-data-dir", default=None,
                   help="preprocessed volumes for periodic zero-shot eval")
    p.add_argument("--valid-labels-csv", default=None)
    p.add_argument("--eval-every", type=int, default=2000)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=100001)
    p.add_argument("--lr", type=float, default=1.25e-6)
    p.add_argument("--results-dir", default="results")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--preprocessed", action="store_true",
                   help="volumes already on the canonical grid")
    p.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process training: the address process 0 listens on (pass on "
                        "every process, with --num-processes and --process-id); each process "
                        "then reads a disjoint ProcessShard of the dataset and --batch-size is "
                        "the GLOBAL batch (must divide by the process count)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None, device="cuda") -> int:
    # ctpa enables XLA's persistent compilation cache here; eager PyTorch
    # has no such cache, and the nvcc-built kernels keep their own
    p = build_parser()
    args = p.parse_args(argv)
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            p.error("--coordinator needs --num-processes and --process-id")
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               device=device)
    elif args.num_processes is not None or args.process_id is not None:
        # without a coordinator each host would train alone on the whole dataset
        p.error("--num-processes/--process-id require --coordinator")

    if args.tiny:
        vit_cfg, bert_cfg = CTViTConfig.tiny(), BertConfig.tiny()
        clip_cfg = CTCLIPConfig.tiny(vit_cfg, bert_cfg)
        pre_cfg = dataclasses.replace(
            PreprocessConfig.train(),
            target_shape=(vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size))
    else:
        # flash_axial: the spatial fold's attention through the flash kernels,
        # wherever the device is not the CPU
        vit_cfg = dataclasses.replace(CTViTConfig(),
                                      flash_axial=torch.device(device).type != "cpu")
        bert_cfg, clip_cfg = BertConfig(), CTCLIPConfig()
        pre_cfg = PreprocessConfig.train()

    model = CTCLIP(clip_cfg, vit_cfg, bert_cfg, device=device)
    tokenizer = HFTokenizer(args.tokenizer) if args.tokenizer else SimpleWordTokenizer(
        vocab_size=bert_cfg.vocab_size)
    dataset = CTReportDataset(args.data_dir, args.reports_csv, metadata_csv=args.metadata_csv)
    print(f"dataset: {len(dataset)} volumes", file=sys.stderr)
    # the position table bounds the tokenization
    max_length = min(512, bert_cfg.max_position_embeddings)
    mesh, local_batch = None, args.batch_size
    if args.coordinator:
        # one data-parallel rank per process; each reads its own shard
        nproc = process_count()
        if args.batch_size % nproc:
            p.error(f"--batch-size {args.batch_size} must divide by the process count {nproc}")
        mesh = create_mesh()
        local_batch = args.batch_size // nproc
        dataset = ProcessShard(dataset)
    loader = build_loader(dataset, tokenizer, local_batch, pre_cfg, device,
                          max_length=max_length, preprocessed=args.preprocessed,
                          process_local=mesh is not None, mesh=mesh)

    first = next(loader)
    model, vq_state = init_state(model, seed=0)
    opt_cfg = OptimizerConfig(lr=args.lr, schedule="cosine_warmup_restarts",
                              total_steps=args.num_steps)
    state = CLIPTrainState.create(model, get_optimizer(opt_cfg, model), vq_state)

    # periodic zero-shot eval: each validation volume encoded once, every
    # pathology's prompt pair scored, the AUROC artifacts under
    # results_dir/zeroshot_step<N>/
    eval_fn = None
    if args.valid_data_dir and args.valid_labels_csv:
        from ctpa_torch.cli.zeroshot_infer import run_zeroshot
        from ctpa_torch.data.datasets import CTReportInferenceDataset
        from ctpa_torch.eval.zeroshot import PATHOLOGIES

        valid_ds = CTReportInferenceDataset(args.valid_data_dir, args.reports_csv,
                                            args.valid_labels_csv, PATHOLOGIES)
        # the inference windowing on the model's input grid
        eval_pre_cfg = dataclasses.replace(PreprocessConfig.inference(),
                                           target_shape=pre_cfg.target_shape)

        def eval_fn(state, step):
            return run_zeroshot(model, state.vq_state, valid_ds, tokenizer,
                                out_dir=f"{args.results_dir}/zeroshot_step{step}",
                                pre_cfg=eval_pre_cfg)

    trainer = CTClipTrainer(
        model, state, itertools.chain([first], loader),
        cfg=TrainConfig(num_train_steps=args.num_steps, save_results_every=args.eval_every,
                        results_dir=args.results_dir, checkpoint_dir=args.checkpoint_dir),
        opt_cfg=opt_cfg, mesh=mesh, eval_fn=eval_fn, model_dtype=torch.float32)
    if args.resume:
        trainer.load()
    with trace(args.profile_dir):
        final = trainer.train()
    trainer.close()
    print("final:", final, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
