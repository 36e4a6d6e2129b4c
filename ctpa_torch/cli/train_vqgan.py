"""CTViT generative (VQGAN) training CLI (port of ``ctpa/cli/train_vqgan.py``):
reconstruction + perceptual + hinge or BCE GAN + VQ commitment, alternating
generator and discriminator updates and the EMA codebook update in one step
(``train/vqgan_trainer.py``).

    python -m ctpa_torch.cli.train_vqgan --data-dir preprocessed/ \\
        --checkpoint-dir vqgan_ckpts --num-steps 10000

As ctpa's CLI: ``CTViTConfig()`` with the decoder, fp32, plain attention
(ctpa's CLI turns on no kernel), ``Discriminator()`` and ``PerceptualNet()``
(``--vgg``: the VGG16 geometry; ``--tiny``: the tiny configurations), Adam
with b1 0.5 and b2 0.9 for both.  Volumes are canonical-grid npz files.
As ctpa's, the batch is data-parallel over dp = gcd(batch, devices)
devices: where the caller has started a process group of several ranks
(``core/mesh.py:initialize_distributed``, one process per card), ranks
0 .. dp-1 each take their rows of every global batch, the gradients and the
VQ statistics are reduced over them (``train/vqgan_trainer.py``), rank 0
alone writes checkpoints, and the other ranks idle.  ``--resume`` continues the step count, both
optimizers, the VQ state and with them the R1 schedule.  The command line
runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np
import torch

from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.core.config import CTViTConfig, MeshConfig
from ctpa_torch.core.init import random_init_
from ctpa_torch.core.mesh import batch_sharding, create_mesh, is_primary, process_count
from ctpa_torch.data.datasets import VolumeDataset, batch_iterator
from ctpa_torch.data.prefetch import PrefetchIterator
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.models.discriminator import Discriminator, PerceptualNet
from ctpa_torch.ops.vq import VQState, vq_init
from ctpa_torch.train.vqgan_trainer import VQGANState, adam, make_vqgan_train_step


@torch.no_grad()
def init_state(model: CTViT, disc: Discriminator, perc: PerceptualNet,
               seed: int = 0) -> VQState:
    """Seeded starting weights of the three networks (``core/init.py:
    random_init_``, one generator in turn) and the VQ codebook
    (``ops/vq.py:vq_init``), on the generator's device."""
    device = model.patch_embed.proj_kernel.device
    gen = torch.Generator(device=device).manual_seed(seed)
    for net in (model, disc, perc):
        random_init_(net, gen)
    return vq_init(gen, model.cfg.codebook_size, model.cfg.dim, device=device)


def collate(samples) -> dict:
    vols = np.stack([s.volume for s in samples]).astype(np.float32)
    if vols.ndim == 4:                       # (b, D, H, W) -> add the channel
        vols = vols[:, None]
    return {"video": vols}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True,
                   help="preprocessed .npz volumes (canonical grid)")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--num-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--disc-lr", type=float, default=3e-4)
    p.add_argument("--bce", action="store_true", help="BCE GAN losses instead of hinge")
    p.add_argument("--gan-weight", type=float, default=1.0)
    p.add_argument("--perceptual-weight", type=float, default=1.0)
    p.add_argument("--vgg", action="store_true",
                   help="full VGG16-geometry perceptual net (import real torchvision weights "
                        "via data/hf_import.py); default is a small random-feature pyramid")
    p.add_argument("--checkpoint-dir", default="vqgan_checkpoints")
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    return p


def main(argv=None, device="cuda") -> int:
    # ctpa enables XLA's persistent compilation cache here; eager PyTorch
    # has no such cache, and the nvcc-built kernels keep their own
    args = build_parser().parse_args(argv)
    # data-parallel over as many ranks as the batch divides into
    mesh = None
    world = process_count()
    if world > 1:
        dp = math.gcd(args.batch_size, world)
        mesh = create_mesh(MeshConfig(data_parallel=dp, model_parallel=1), ranks=range(dp))
        if mesh is None:
            print(f"rank outside the {dp} data-parallel ranks: idle", file=sys.stderr)
            return 0
    vit_cfg = dataclasses.replace(CTViTConfig.tiny() if args.tiny else CTViTConfig(),
                                  use_decoder=True)
    model = CTViT(vit_cfg, device=device)
    disc_kw = dict(base_dim=8, num_layers=2) if args.tiny else {}
    disc = Discriminator(image_size=vit_cfg.image_size, device=device, **disc_kw)
    perc = (PerceptualNet(stages=(8, 16), device=device) if args.tiny
            else PerceptualNet.vgg16(device=device) if args.vgg else PerceptualNet(device=device))

    dataset = VolumeDataset(args.data_dir)
    print(f"dataset: {len(dataset)} volumes", file=sys.stderr)
    loader = PrefetchIterator(batch_iterator(dataset, args.batch_size, collate), device=device,
                              sharding=None if mesh is None else batch_sharding(mesh))

    batch = next(loader)
    vq_state = init_state(model, disc, perc)
    gen_tx = adam(model, args.lr)
    disc_tx = adam(disc, args.disc_lr)
    state = VQGANState(gen=model, disc=disc, perc=perc, gen_opt=gen_tx, disc_opt=disc_tx,
                       vq_state=vq_state)

    mgr = CheckpointManager(args.checkpoint_dir)
    if args.resume and mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore(map_location=device))
        print(f"resumed at step {state.step}", file=sys.stderr)

    step_fn = make_vqgan_train_step(model, disc, perc, gen_tx, disc_tx, use_hinge=not args.bce,
                                    gan_weight=args.gan_weight,
                                    perceptual_weight=args.perceptual_weight, mesh=mesh)
    while state.step < args.num_steps:
        state, metrics = step_fn(state, batch["video"])
        step = state.step
        if step % args.log_every == 0 or step == 1:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            print(f"step {step}: {m}", file=sys.stderr)
        if (step % args.save_every == 0 or step == args.num_steps) and is_primary():
            mgr.save(step, state.state_dict())
        try:
            batch = next(loader)
        except StopIteration:
            break
    if mgr.latest_step() != state.step and is_primary():
        mgr.save(state.step, state.state_dict(), force=True)
    mgr.wait()
    print(f"done at step {state.step}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
