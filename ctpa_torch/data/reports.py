"""Radiology report text cleaning (a pandas-free copy of
``ctpa/data/reports.py``; the port imports nothing of ``ctpa``).

Behavioral parity with reference reports_prep.py:5-85: extract the IMPRESSION
section(s), drop end-markers and summaries, lowercase, strip numbered-point
prefixes, de-identification placeholders (<hcw>, <time>, <date>), standalone
numbers (keeping "N months"/"N mm" measurements), and clinician-communication
boilerplate ("discussed with ... at ... on ...").  The reference enumerates
~40 literal boilerplate regexes; here the same sentence family is matched by a
compact grammar over (communication verb) + (recipient) + (time/date tail),
which covers the reference's cases and generalizes.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

import numpy as np

from ctpa_torch.data.manifests import read_csv, write_csv

_IMPRESSION_SPLIT = re.compile(r"IMPRESSION:\s*", re.IGNORECASE)
_END_MARKERS = (
    re.compile(r"END OF IMPRESSION:.*", re.IGNORECASE | re.DOTALL),
    re.compile(r"SUMMARY[:\d-]*\s*", re.IGNORECASE),
)
_NUMBERED_POINT = re.compile(r"\b\d+\.\s*")
_PLACEHOLDERS = re.compile(r"<(?:hcw|time|date)>")
_STANDALONE_NUM = re.compile(r"\b\d+\b(?!\s(months|mm))")
_MULTI_SPACE = re.compile(r"\s+")
_SPACE_COMMA = re.compile(r"(\s,)+")
_SPACE_PERIOD = re.compile(r"\s+\.")

# one grammar for the clinician-communication boilerplate family:
#   <preamble>? <verb phrase> ... (with|to) <recipient> ... <tail>? .
_COMM_VERBS = (
    r"(?:was\s+|were\s+|is\s+)?"
    r"(?:discussed|communicated|relayed|conveyed|reviewed|reported|provided|"
    r"escalated|verified and communicated|sent|made|conducted|occurred|added)"
)
_COMM_SENTENCE = re.compile(
    r"[^.]*\b" + _COMM_VERBS + r"\b[^.]*\b(?:with|to)\b[^.]*\."
    r"|[^.]*\b(?:discussion|notification|phone call|consultation|communication|"
    r"follow-up discussion)\b[^.]*\b(?:with|to|regarding)\b[^.]*\.",
    re.IGNORECASE,
)
_COMM_PREFIXES = re.compile(
    r"[^.]*\b(?:preliminary (?:findings?|report)|final (?:report|interpretation)|"
    r"on-call case|non-called case)\b[^.]*\b(?:provided by|discussed|communicated)"
    r"[^.]*\.",
    re.IGNORECASE,
)


def clean_impression(text: object) -> Optional[str]:
    """Extract+normalize impression sections; None when nothing survives."""
    if not isinstance(text, str) or not text.strip():
        return None
    # strip end-markers BEFORE splitting: "END OF IMPRESSION:" contains the
    # section delimiter, so splitting first would resurrect the trailer text
    # (a quirk the reference actually has — fixed here, SURVEY.md §7).
    for marker in _END_MARKERS:
        text = marker.sub("", text)
    sections = _IMPRESSION_SPLIT.split(text)[1:]
    cleaned = []
    for imp in sections:
        imp = imp.strip().lower()
        imp = _NUMBERED_POINT.sub("", imp)
        imp = _COMM_PREFIXES.sub("", imp)
        imp = _COMM_SENTENCE.sub("", imp)
        imp = _PLACEHOLDERS.sub("", imp)
        imp = _STANDALONE_NUM.sub("", imp)
        imp = _MULTI_SPACE.sub(" ", imp)
        imp = _SPACE_COMMA.sub("", imp)
        imp = _SPACE_PERIOD.sub(".", imp)
        imp = _MULTI_SPACE.sub(" ", imp).strip()
        if imp:
            cleaned.append(imp)
    out = " ".join(cleaned).strip()
    return out or None


def normalize_for_training(text: str) -> str:
    """Quote/char scrubbing applied at batch time by the train dataset
    (ct_clip/data.py:199-205 semantics: strip quotes and parentheses chars)."""
    for ch in ('"', "'", "(", ")"):
        text = text.replace(ch, "")
    return text


def clean_reports_csv(
    in_csv: str,
    out_csv: str,
    text_column: str = "impressions",
) -> list[dict]:
    """CSV-level entry (reports_prep.py:88-93): clean the text column, drop
    rows where nothing survives; writes ``out_csv`` as ctpa's pandas
    round trip does and returns the kept rows."""
    table = read_csv(in_csv)
    kept = []
    for row in table.rows:
        text = clean_impression(row[text_column])
        if text:
            kept.append({**row, text_column: text})
    write_csv(out_csv, kept, table.columns, {**table.kinds, text_column: "object"})
    return kept


def train_test_split_by_name(
    names: Iterable[str], train_frac: float = 0.8, seed: Optional[int] = None,
) -> tuple[list[str], list[str]]:
    """80/20 split (split_reports.py:1-23).  The reference splits by directory
    listing order; pass seed=None for that determinism-by-order behavior or a
    seed for a shuffled split."""
    names = list(names)
    if seed is not None:
        rng = np.random.default_rng(seed)
        names = [names[i] for i in rng.permutation(len(names))]
    k = int(len(names) * train_frac)
    return names[:k], names[k:]
