"""Zero-shot pathology classification from prompt pairs (port of
``ctpa/eval/zeroshot.py``).  Each volume is encoded once; the 2*P prompt
latents are input-independent, so they are encoded once, in one batched
text forward, and cached."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

# reference order, 18 entries, 'Pulmonary Embolism' at position 12; label
# matrices and by-position consumers depend on it
PATHOLOGIES: tuple[str, ...] = (
    "Medical material", "Arterial wall calcification", "Cardiomegaly",
    "Pericardial effusion", "Coronary artery wall calcification",
    "Hiatal hernia", "Lymphadenopathy", "Emphysema", "Atelectasis",
    "Lung nodule", "Lung opacity", "Pulmonary Embolism", "Pleural effusion",
    "Mosaic attenuation pattern", "Peribronchial thickening", "Consolidation",
    "Bronchiectasis", "Interlobular septal thickening",
)


def prompt_pairs(pathologies: Sequence[str] = PATHOLOGIES) -> list[str]:
    """Flat list [p0_pos, p0_neg, p1_pos, ...]."""
    out = []
    for p in pathologies:
        out.append(f"{p} is present.")
        out.append(f"{p} is not present.")
    return out


def score_prompt_pairs(image_latents: torch.Tensor, prompt_latents: torch.Tensor,
                       temperature) -> torch.Tensor:
    """(b, P) probability of 'present': softmax over each (present, absent)
    pair of temperature-scaled cosine similarities."""
    sim = torch.matmul(image_latents.to(torch.float32),
                       prompt_latents.to(torch.float32).t()) * temperature
    pairs = sim.reshape(sim.shape[0], -1, 2)
    return torch.softmax(pairs, dim=-1)[..., 0]


class ZeroShotClassifier:
    """Caches the prompt latents once; scores batches of volume latents.

    encode_text: (input_ids, attention_mask) -> (n, d) latents
    tokenize: list[str] -> (input_ids, attention_mask) tensors
    temperature: exp of the learned log-temperature
    """

    def __init__(self, encode_text: Callable, tokenize: Callable, temperature,
                 pathologies: Sequence[str] = PATHOLOGIES):
        self.pathologies = tuple(pathologies)
        ids, mask = tokenize(prompt_pairs(self.pathologies))
        with torch.no_grad():
            self.prompt_latents = encode_text(ids, mask).to(torch.float32)
        self.temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                           device=self.prompt_latents.device)

    def score(self, image_latents: torch.Tensor) -> torch.Tensor:
        return score_prompt_pairs(image_latents, self.prompt_latents, self.temperature)

    def predict(self, image_latents: torch.Tensor) -> np.ndarray:
        return self.score(image_latents).cpu().numpy()
