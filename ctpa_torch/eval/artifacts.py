"""Evaluation artifact writers — npz/txt/json/csv outputs (port of
``ctpa/eval/artifacts.py``, without pandas).

Reference surfaces: the zero-shot run's labels/predictions npz, accessions
txt and AUROC table; the VQA run's JSON + CSV results; per-sample tri-plane
CT visualizations + prompt/reference/prediction text files.  The AUROC table
is written as ``aurocs.csv``, which is ctpa's own output when no Excel
engine is installed; the card's machine has none."""

from __future__ import annotations

import json
import os
import sys
from typing import Sequence

import numpy as np

from ctpa_torch.data.manifests import write_csv
from ctpa_torch.eval.classification import table_rows


def write_zeroshot_artifacts(
    out_dir: str,
    predictions: np.ndarray,
    labels: np.ndarray,
    accessions: Sequence[str],
    aurocs: dict[str, list],
    prefix: str = "",
) -> dict[str, str]:
    """labels/predicted npz + accessions.txt + aurocs.csv (``aurocs``: a
    table of columns, as ``evaluate_classification`` returns)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    p = os.path.join(out_dir, f"{prefix}labels_weights.npz")
    np.savez(p, data=labels)
    paths["labels"] = p
    p = os.path.join(out_dir, f"{prefix}predicted_weights.npz")
    np.savez(p, data=predictions)
    paths["predictions"] = p
    p = os.path.join(out_dir, f"{prefix}accessions.txt")
    with open(p, "w") as f:
        f.write("\n".join(accessions))
    paths["accessions"] = p
    p = os.path.join(out_dir, f"{prefix}aurocs.csv")
    write_csv(p, table_rows(aurocs), list(aurocs))
    paths["aurocs"] = p
    return paths


def write_nlg_results(
    out_dir: str,
    records: list[dict],
    metrics: dict,
    name: str = "evaluation",
) -> dict[str, str]:
    """JSON (metrics + per-sample records) and CSV (records) writers."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    p = os.path.join(out_dir, f"{name}_results.json")
    with open(p, "w") as f:
        json.dump({"metrics": metrics, "samples": records}, f, indent=2)
    paths["json"] = p
    p = os.path.join(out_dir, f"{name}_results.csv")
    write_csv(p, records)
    paths["csv"] = p
    return paths


def visualize_sample(
    out_dir: str,
    volume: np.ndarray,          # (1, D, H, W) or (D, H, W)
    prompt: str,
    reference: str,
    prediction: str,
    sample_id: str,
):
    """Tri-plane (axial/coronal/sagittal) middle-slice PNG + text file.  The
    text file is written either way; the PNG only where matplotlib imports
    (a note on stderr says when it is skipped)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{sample_id}_text.txt"), "w") as f:
        f.write(f"PROMPT:\n{prompt}\n\nREFERENCE:\n{reference}\n\nPREDICTION:\n{prediction}\n")
    try:
        import matplotlib
    except ImportError:
        print(f"visualize_sample: matplotlib is not installed; {sample_id}_triplane.png "
              f"is skipped", file=sys.stderr)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vol = volume[0] if volume.ndim == 4 else volume
    d, h, w = vol.shape
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].imshow(vol[d // 2], cmap="gray")
    axes[0].set_title("axial")
    axes[1].imshow(vol[:, h // 2], cmap="gray", aspect="auto")
    axes[1].set_title("coronal")
    axes[2].imshow(vol[:, :, w // 2], cmap="gray", aspect="auto")
    axes[2].set_title("sagittal")
    for ax in axes:
        ax.axis("off")
    fig.suptitle(sample_id)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"{sample_id}_triplane.png"))
    plt.close(fig)
