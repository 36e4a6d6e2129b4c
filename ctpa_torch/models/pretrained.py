"""Pretrained-model factory (port of ``ctpa/models/pretrained.py``): the
reference's ``pretrained_model.py`` surface without its import-time side
effects.

The reference builds tokenizer + CXR-BERT + CTViT + CTCLIP and loads
``CT-CLIP_v2.pt`` at import time as a module-level singleton.  Here the same
assembly is an explicit factory: the shipped configs, seeded init, and
optional checkpoint, BERT weights and tokenizer from local paths (pass
snapshot directories, not hub names).  The parameters live in the returned
module, so ``PretrainedCTCLIP`` has no ``params`` field; ``skipped`` lists
what a torch checkpoint held that the model has no place for.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
from ctpa_torch.core.init import random_init_
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.ops.vq import VQState, vq_init


@dataclass
class PretrainedCTCLIP:
    model: CTCLIP
    vq_state: VQState
    tokenizer: Any
    vit_cfg: CTViTConfig
    bert_cfg: BertConfig
    clip_cfg: CTCLIPConfig
    skipped: list[str] = field(default_factory=list)


def shipped_configs() -> tuple[CTViTConfig, BertConfig, CTCLIPConfig]:
    """The shipped CT-CLIP geometry."""
    return CTViTConfig(), BertConfig(), CTCLIPConfig()


def build_ctclip(
    checkpoint_path: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    bert_weights: Optional[str] = None,
    vit_cfg: Optional[CTViTConfig] = None,
    bert_cfg: Optional[BertConfig] = None,
    clip_cfg: Optional[CTCLIPConfig] = None,
    dtype=torch.float32,
    seed: int = 0,
    device="cuda",
) -> PretrainedCTCLIP:
    """Assemble CTCLIP on ``device`` with ``dtype`` parameters.

    checkpoint_path: a reference ``CT-CLIP_v2.pt`` torch checkpoint, or a
    directory of this package's ``CheckpointManager`` store as
    ``CTClipTrainer.save`` writes it ({"params", "vq_state", ...}).
    tokenizer_path: local HF tokenizer snapshot (CXR-BERT; needs
    ``transformers``); without it the deterministic SimpleWordTokenizer.
    bert_weights: local HF BertModel snapshot for the text tower when no
    full CLIP checkpoint is given (loaded strictly).
    """
    explicit_vit_cfg = vit_cfg is not None
    vit_cfg = vit_cfg or CTViTConfig()
    bert_cfg = bert_cfg or BertConfig()
    clip_cfg = clip_cfg or CTCLIPConfig()

    if (checkpoint_path and not os.path.isdir(checkpoint_path)
            and not explicit_vit_cfg and not vit_cfg.peg_reference_layout):
        # A torch .pt checkpoint is a reference artifact: its weights were
        # trained with the reference PEG's temporal-fold scramble, so
        # reproduce that layout or the imported weights silently diverge
        # from reference activations and AUROCs.  Pass an explicit vit_cfg
        # to override.
        vit_cfg = replace(vit_cfg, peg_reference_layout=True)

    gen = torch.Generator(device=device).manual_seed(seed)
    model = CTCLIP(clip_cfg, vit_cfg, bert_cfg, device=device, dtype=dtype)
    random_init_(model, gen)
    vq_state = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=device)
    skipped: list[str] = []

    if checkpoint_path:
        if os.path.isdir(checkpoint_path):
            from ctpa_torch.core.checkpoint import CheckpointManager

            state = CheckpointManager(checkpoint_path).restore(map_location=device)
            if state is not None:
                model.load_state_dict(state["params"])
                if state.get("vq_state") is not None:
                    vq_state = VQState(**{k: torch.as_tensor(v, device=device)
                                          for k, v in state["vq_state"].items()})
        else:
            from ctpa_torch.convert import overlay_flax_params
            from ctpa_torch.data.hf_import import import_ctclip, load_torch_checkpoint

            sd = load_torch_checkpoint(checkpoint_path)
            imported, extras = import_ctclip(
                sd, bert_cfg, vit_cfg.spatial_depth, vit_cfg.temporal_depth)
            del sd
            # strict=False load parity: tolerate missing and mis-shaped keys
            skipped = overlay_flax_params(model, imported, allow_missing=True)
            if "vq_codebook" in extras:
                codebook = torch.as_tensor(extras["vq_codebook"], dtype=torch.float32,
                                           device=device)
                vq_state = vq_state._replace(codebook=codebook, embed_avg=codebook.clone())
    elif bert_weights:
        from ctpa_torch.convert import load_flax_params
        from ctpa_torch.data.hf_import import import_bert, load_hf_snapshot

        sd = load_hf_snapshot(bert_weights)
        prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
        load_flax_params(model.text_transformer, import_bert(sd, bert_cfg, prefix=prefix))

    if tokenizer_path:
        from ctpa_torch.data.tokenizer import HFTokenizer

        tokenizer = HFTokenizer(tokenizer_path)
    else:
        from ctpa_torch.data.tokenizer import SimpleWordTokenizer

        tokenizer = SimpleWordTokenizer(vocab_size=bert_cfg.vocab_size)

    return PretrainedCTCLIP(model=model, vq_state=vq_state, tokenizer=tokenizer,
                            vit_cfg=vit_cfg, bert_cfg=bert_cfg, clip_cfg=clip_cfg,
                            skipped=skipped)
