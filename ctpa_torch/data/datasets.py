"""Datasets and batch iterators — host-side numpy, feeding device
preprocessing (a pandas-free copy of ``ctpa/data/datasets.py``; the port
imports nothing of ``ctpa``).

The host side only LOADS bytes (npz/NIfTI) and looks up metadata; HU
rescale + resample + crop/pad run on the device via
``ctpa_torch.ops.preprocess``.  CSVs are read by ``data.manifests.read_csv``,
whose rows carry the ids and labels ``pd.read_csv`` gives.  Batches
therefore carry the RAW volume plus (slope, intercept, spacing) scalars.
Same-shaped raw volumes are required per batch (bucket by shape upstream or
pre-extract to a common raw grid); `CTReportDataset.preprocessed=True`
supports the offline-preprocessed layout where volumes are already on the
canonical grid.

Parity surfaces:
  * CTReportDataset        (train: volume + report text)       data.py:43-205
  * CTReportInferenceDataset (volume + text + one-hot labels + accession)
                                                               data_inference.py:15-132
  * VQADataset             (jsonl {image_path, question, answer})
                                                               vqa_meditron.py:143-188
  * ReportGenDataset       (jsonl {image_path, report} + prompt)
                                                               data_utils.py:14-109
Bad samples raise (the reference returned dummy tensors / randn features —
silent corruption, SURVEY.md §4 — deliberately not reproduced).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ctpa_torch.core.logging import get_logger
from ctpa_torch.data.manifests import iterrows, metadata_lookup, read_csv, read_jsonl
from ctpa_torch.data.reports import normalize_for_training

REPORT_PROMPT = "Generate a detailed clinical report for this CT scan:"  # data_utils.py:63


def load_npz_volume(path: str) -> np.ndarray:
    with np.load(path) as z:
        key = "arr_0" if "arr_0" in z else list(z.keys())[0]
        return np.asarray(z[key])


@dataclass
class Sample:
    volume: np.ndarray              # raw (z, y, x) or preprocessed (1, D, H, W)
    text: str
    slope: float = 1.0
    intercept: float = 0.0
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    labels: Optional[np.ndarray] = None
    accession: str = ""


class CTReportDataset:
    """Volume + cleaned report pairs for contrastive training."""

    def __init__(
        self,
        data_dir: str,
        reports_csv: str,
        metadata_csv: Optional[str] = None,
        id_column: str = "impression_id",
        text_column: str = "impressions",
        train_fraction: float = 1.0,
        preprocessed: bool = False,
    ):
        self.text_by_id = {
            str(r[id_column]): str(r[text_column]) for r in iterrows(read_csv(reports_csv))
        }
        self.meta = (
            metadata_lookup(iterrows(read_csv(metadata_csv))) if metadata_csv else {}
        )
        self.preprocessed = preprocessed
        self.samples: list[tuple[str, str]] = []
        for root, _, files in os.walk(data_dir):
            for fname in sorted(files):
                if not fname.endswith(".npz"):
                    continue
                vid = os.path.splitext(fname)[0]
                if vid in self.text_by_id:
                    self.samples.append((os.path.join(root, fname), vid))
        # optional train-subset truncation (data.py:59-61 uses 80%)
        k = int(len(self.samples) * train_fraction)
        self.samples = self.samples[:k]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Sample:
        path, vid = self.samples[idx]
        vol = load_npz_volume(path)
        text = normalize_for_training(self.text_by_id[vid])
        if not self.meta:
            return Sample(volume=vol, text=text)
        m = self.meta.get(vid)
        if m is None:
            # fail loudly: a silent default spacing would corrupt resampling
            # (the reference raises here too, data.py:127)
            raise KeyError(f"metadata not found for volume {vid!r}")
        return Sample(volume=vol, text=text, slope=m["slope"],
                      intercept=m["intercept"], spacing=m["spacing"])


class VolumeDataset:
    """All .npz volumes under a directory — report-free workloads (VQGAN
    reconstruction training, SSL pretraining) where text pairing is not
    needed.  Volumes are expected on the canonical preprocessed grid."""

    def __init__(self, data_dir: str):
        self.paths: list[str] = []
        for root, _, files in os.walk(data_dir):
            for fname in sorted(files):
                if fname.endswith(".npz"):
                    self.paths.append(os.path.join(root, fname))
        if not self.paths:
            raise FileNotFoundError(f"no .npz volumes under {data_dir}")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> Sample:
        return Sample(volume=load_npz_volume(self.paths[idx]), text="")


class CTReportInferenceDataset:
    """Volume + text + one-hot pathology labels + accession for zero-shot eval
    (data_inference.py:15-132; labels.csv one-hot columns per pathology)."""

    def __init__(
        self,
        data_dir: str,
        reports_csv: str,
        labels_csv: str,
        pathologies: Sequence[str],
        id_column: str = "impression_id",
        text_column: str = "impressions",
    ):
        self.text_by_id = {str(r[id_column]): str(r[text_column])
                           for r in iterrows(read_csv(reports_csv))}
        labels = read_csv(labels_csv)
        label_id_col = labels.columns[0]
        self.pathologies = list(pathologies)
        self.labels_by_id = {
            str(r[label_id_col]): np.asarray(
                [float(r.get(p, 0.0)) for p in self.pathologies], np.float32)
            for r in iterrows(labels)
        }
        self.samples = []
        for root, _, files in os.walk(data_dir):
            for fname in sorted(files):
                if fname.endswith(".npz"):
                    vid = os.path.splitext(fname)[0]
                    if vid in self.text_by_id and vid in self.labels_by_id:
                        self.samples.append((os.path.join(root, fname), vid))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Sample:
        path, vid = self.samples[idx]
        return Sample(
            volume=load_npz_volume(path),
            text=self.text_by_id[vid],
            labels=self.labels_by_id[vid],
            accession=vid,
        )


class VQADataset:
    """JSONL {image_path, question, answer} (vqa_meditron.py:143-188).  Text is
    question + " " + answer; a label mask marks answer tokens for the loss."""

    def __init__(self, jsonl_path: str):
        self.items = read_jsonl(jsonl_path)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        it = self.items[idx]
        return {
            "volume": load_npz_volume(it["image_path"]),
            "question": str(it["question"]),
            "answer": str(it["answer"]),
        }


class ReportGenDataset:
    """JSONL {image_path, report} with the generation prompt prefix
    (data_utils.py:14-109)."""

    def __init__(self, jsonl_path: str, prompt: str = REPORT_PROMPT):
        self.items = read_jsonl(jsonl_path)
        self.prompt = prompt

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        it = self.items[idx]
        return {
            "volume": load_npz_volume(it["image_path"]),
            "prompt": self.prompt,
            "report": str(it["report"]),
        }


# ---------------------------------------------------------------- batching


def collate_clip(samples: Sequence[Sample], tokenizer, max_length: int = 512) -> dict:
    """Host batch for the CLIP trainer: stacked raw volumes + scalars + tokens
    (custom_collate parity, CTCLIPTrainer.py:52-66)."""
    toks = tokenizer([s.text for s in samples], max_length=max_length)
    batch = {
        "video": np.stack([s.volume for s in samples]).astype(np.float32),
        "input_ids": toks["input_ids"],
        "attention_mask": toks["attention_mask"],
        "slope": np.asarray([s.slope for s in samples], np.float32),
        "intercept": np.asarray([s.intercept for s in samples], np.float32),
        "spacing": np.asarray([s.spacing for s in samples], np.float32),
    }
    if samples[0].labels is not None:
        batch["labels"] = np.stack([s.labels for s in samples])
    return batch


class ProcessShard:
    """Process-disjoint view of a dataset for multi-process data parallelism.

    Each process sees a strided (round-robin) slice — process p of P gets
    indices p, p+P, p+2P, … — so every sample is read by exactly ONE host and
    shards stay balanced even on sorted manifests.  This is the data-layer
    fix for the reference's broken DDP sharding (accelerate.prepare called on
    a cycle() iterator, CTCLIPTrainer.py:260-275 — every rank trained on the
    same stream).  By default the process is the ``torch.distributed`` rank
    of the default group (0 of 1 when none is initialized)."""

    def __init__(self, dataset, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        import torch.distributed as dist

        on = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if on else 0
        if process_count is None:
            process_count = dist.get_world_size() if on else 1
        self.dataset = dataset
        self.index, self.count = process_index, process_count
        if not 0 <= self.index < self.count:
            raise ValueError(
                f"process_index {self.index} not in [0, {self.count})")

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n - self.index + self.count - 1) // self.count

    def __getitem__(self, i: int):
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self.dataset[self.index + i * self.count]


def batch_iterator(
    dataset,
    batch_size: int,
    collate: Callable,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    cycle: bool = True,
    on_error: str = "raise",
) -> Iterator[dict]:
    """Epoch iterator.  With several processes, wrap the dataset in
    `ProcessShard` so each process reads only its slice.

    on_error: 'raise' (default) or 'skip' — skip-and-LOG replaces the
    reference's silent dummy-tensor substitution (SURVEY.md §5.3): a corrupt
    sample is dropped and the next index backfills the batch, with a rank-0
    warning naming the failure."""
    assert on_error in ("raise", "skip")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
        pos = 0
        while pos < len(order):
            samples = []
            while len(samples) < batch_size and pos < len(order):
                idx = int(order[pos])
                pos += 1
                try:
                    samples.append(dataset[idx])
                except Exception as e:  # noqa: BLE001
                    if on_error == "raise":
                        raise
                    get_logger().warning("skipping sample %d: %s", idx, e)
            if len(samples) == batch_size or (samples and not drop_last):
                yield collate(samples)
        if not cycle:
            return
