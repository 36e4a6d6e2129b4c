"""The pandas-free data layer, the numpy evaluation and the two CLIs of the
port against ctpa's on the CPU, on files the tests write from a seed:
``data.manifests`` (the CSV reader and writer, metadata, split CSVs, VQA
manifest), ``data.reports``, ``data.datasets``, ``eval.classification``
(against sklearn and ctpa), ``eval.artifacts``, ``cli.preprocess`` and
``cli.zeroshot_infer`` end to end.

Tolerances: ids, texts, labels, CSV bytes and JSONL are held equal;
AUROC within 1e-12 of sklearn and the bootstrap and Youden tables within
1e-12 of ctpa's (the same float64 arithmetic, summed in another order);
preprocessed volumes within the 1e-5 of ``tests/test_torch_ops.py`` (fp32
contractions in another order); zero-shot predictions and the CSVs written
from them within 1e-5 (fp32 towers in flax and torch).
"""

import csv
import dataclasses
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ctpa.cli import preprocess as jpre_cli
from ctpa.cli import zeroshot_infer as jzs_cli
from ctpa.core import config as jc
from ctpa.data import datasets as jds
from ctpa.data import manifests as jman
from ctpa.data import reports as jrep
from ctpa.data.tokenizer import SimpleWordTokenizer as JTok
from ctpa.eval import classification as jcls
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.ops.vq import VQState as JVQState
from ctpa_torch.cli import preprocess as tpre_cli
from ctpa_torch.cli import zeroshot_infer as tzs_cli
from ctpa_torch.convert import load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.data import datasets as tds
from ctpa_torch.data import dicom, nifti
from ctpa_torch.data import manifests as tman
from ctpa_torch.data import reports as trep
from ctpa_torch.eval import artifacts as tart
from ctpa_torch.eval import classification as tcls
from ctpa_torch.eval.zeroshot import PATHOLOGIES
from ctpa_torch.models.ctclip import CTCLIP

torch.set_num_threads(1)
ATOL = 1e-5           # tests/test_torch_ops.py's ATOL
EXACT = 1e-12


def _same(a, b):
    """Equal, NaN equal to NaN (values and numpy arrays)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return a == b


# ------------------------------------------------------ CSV and data rows

# (reports CSV, labels CSV, npz names): each a pandas trap of the id column
CASES = {
    "leading zeros": (
        'impression_id,impressions\n00123,"Lung nodule, small."\n456,"two\nlines"\n'
        '789,NA\n',
        "VolumeName,Lung nodule,Pleural effusion\n00123,1,0\n456,0,1\n789,1,1\n",
        ["00123", "123", "456", "789"]),
    "id column with a gap": (
        'impression_id,impressions\n123,"a, b"\n,None\n456,null\n',
        "VolumeName,Lung nodule,Emphysema\n123,1,0\n,0,1\n456,NA,1\n",
        ["123", "123.0", "456.0", "nan"]),
    "all-numeric labels upcast": (
        "impression_id,impressions,score\n7,text one,1.5\n,gap,\n8,,2\n",
        "id,Lung nodule,Cardiomegaly\n7,1,0.5\n8,0,1\n",
        ["7", "7.0", "8.0", "8"]),
    "quoted and NA strings": (
        'impression_id,impressions\n"a,1","He said ""NA"" twice"\nb-2,N/A\nc 3,#NA\n'
        'd4,"  spaced  "\n\nTrue,null\n',
        "VolumeName,Atelectasis\nb-2,1\nd4,0\na,1\nTrue,0\n",
        ["a,1", "b-2", "c 3", "d4", "True", "nan"]),
}


def _write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


def _npz_tree(root, names, shape=(4, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    for i, name in enumerate(names):
        sub = os.path.join(root, f"shard_{i % 2}")
        os.makedirs(sub, exist_ok=True)
        np.savez(os.path.join(sub, name + ".npz"), rng.normal(size=shape).astype(np.float32))
    return str(root)


@pytest.mark.parametrize("case", list(CASES))
def test_csv_rows_match_pandas(tmp_path, case):
    """read_csv's columns and kinds, and iterrows' values (type and str), are
    pd.read_csv's and DataFrame.iterrows'."""
    for text in CASES[case][:2]:
        path = _write(tmp_path / "x.csv", text)
        table = tman.read_csv(path)
        df = pd.read_csv(path)
        assert table.columns == list(df.columns)
        kinds = {c: {"i": "int", "f": "float", "b": "bool"}.get(df[c].dtype.kind, "object")
                 for c in df.columns}
        assert table.kinds == kinds
        rows = tman.iterrows(table)
        assert len(rows) == len(df)
        for got, (_, ref) in zip(rows, df.iterrows()):
            for c in df.columns:
                want = ref[c].item() if isinstance(ref[c], np.generic) else ref[c]
                assert str(got[c]) == str(want) and type(got[c]) is type(want), (c, got[c], want)
                assert _same(got[c], want), (c, got[c], want)


def test_na_strings_are_pandas():
    from pandas._libs.parsers import STR_NA_VALUES

    assert tman.NA_STRINGS == STR_NA_VALUES


@pytest.mark.parametrize("case", list(CASES))
def test_inference_dataset_rows_match_ctpa(tmp_path, case):
    """CTReportInferenceDataset: the same texts, labels (a missing pathology
    column reads 0.0), samples and items as ctpa's on the same files."""
    reports_text, labels_text, names = CASES[case]
    reports = _write(tmp_path / "reports.csv", reports_text)
    labels = _write(tmp_path / "labels.csv", labels_text)
    data = _npz_tree(tmp_path / "data", names)
    pathologies = ["Lung nodule", "Pleural effusion", "Emphysema", "Atelectasis",
                   "Cardiomegaly", "Hiatal hernia"]
    ref = jds.CTReportInferenceDataset(data, reports, labels, pathologies)
    got = tds.CTReportInferenceDataset(data, reports, labels, pathologies)
    assert got.text_by_id == ref.text_by_id
    assert sorted(got.labels_by_id) == sorted(ref.labels_by_id)
    for k, v in ref.labels_by_id.items():
        assert got.labels_by_id[k].dtype == v.dtype and _same(got.labels_by_id[k], v), k
    assert got.samples == ref.samples and len(got) > 0
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert (b.text, b.accession) == (a.text, a.accession)
        assert _same(b.labels, a.labels) and np.array_equal(b.volume, a.volume)


@pytest.mark.parametrize("case", list(CASES))
def test_report_dataset_and_metadata_lookup_match_ctpa(tmp_path, case):
    """CTReportDataset with a metadata CSV (XYSpacing as floats and as
    stringified lists): the same samples, texts, metadata and items."""
    reports_text, _, names = CASES[case]
    reports = _write(tmp_path / "reports.csv", reports_text)
    data = _npz_tree(tmp_path / "data", names)
    meta = str(tmp_path / "meta.csv")
    with open(meta, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VolumeName", "RescaleSlope", "RescaleIntercept", "XYSpacing", "ZSpacing",
                    "NumSlices"])
        for n, sp in zip(names, ["[0.75, 0.75]", "0.7", "(0.8, 0.8)", "0.5", "0.6", "0.9"]):
            w.writerow([n + ".nii.gz", "1.0", "-1024", sp, "2.5", "40"])
    ref = jds.CTReportDataset(data, reports, meta)
    got = tds.CTReportDataset(data, reports, meta)
    assert got.text_by_id == ref.text_by_id and got.meta == ref.meta
    assert got.meta == jman.metadata_lookup(pd.read_csv(meta))
    assert got.samples == ref.samples
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert (b.text, b.slope, b.intercept, b.spacing) == (a.text, a.slope, a.intercept,
                                                             a.spacing)


def test_other_datasets_and_batching_match_ctpa(tmp_path):
    """VolumeDataset, VQADataset, ReportGenDataset, collate_clip,
    ProcessShard and batch_iterator (shuffled, skipping a bad sample) give
    ctpa's items and batches."""
    from ctpa_torch.data.tokenizer import SimpleWordTokenizer

    names = ["a", "b", "c", "d", "e"]
    data = _npz_tree(tmp_path / "data", names, shape=(2, 3, 4))
    paths = sorted(str(q) for q in (tmp_path / "data").rglob("*.npz"))
    items = tmp_path / "items.jsonl"
    items.write_text("".join(
        f'{{"image_path": "{q}", "question": "q{i}?", "answer": {i}, "report": "r{i}"}}\n'
        for i, q in enumerate(paths)) + "\n")
    for cls, arg in (("VolumeDataset", data), ("VQADataset", str(items)),
                     ("ReportGenDataset", str(items))):
        ref, got = getattr(jds, cls)(arg), getattr(tds, cls)(arg)
        assert len(got) == len(ref) == len(names)
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            a, b = (a, b) if isinstance(a, dict) else (vars(a), vars(b))
            assert sorted(a) == sorted(b)
            assert all(_same(b[k], a[k]) for k in a), cls
    reports = _write(tmp_path / "r.csv", "impression_id,impressions\n" + "".join(
        f'{n},"Report (of) \'{n}\'."\n' for n in names))

    class Flaky:
        """A dataset whose third sample cannot be read."""

        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            if i == 2:
                raise OSError("unreadable")
            return self.ds[i]

    ref_ds, got_ds = jds.CTReportDataset(data, reports), tds.CTReportDataset(data, reports)
    jt, tt = JTok(vocab_size=512, max_length=16), SimpleWordTokenizer(512, 16)
    ref = list(jds.batch_iterator(Flaky(ref_ds), 2, lambda s: jds.collate_clip(s, jt, 16),
                                  seed=3, drop_last=False, cycle=False, on_error="skip"))
    got = list(tds.batch_iterator(Flaky(got_ds), 2, lambda s: tds.collate_clip(s, tt, 16),
                                  seed=3, drop_last=False, cycle=False, on_error="skip"))
    assert len(got) == len(ref) == 2
    for a, b in zip(ref, got):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for index in range(3):
        rs, gs = jds.ProcessShard(ref_ds, index, 3), tds.ProcessShard(got_ds, index, 3)
        assert len(gs) == len(rs)
        assert [gs[i].text for i in range(len(gs))] == [rs[i].text for i in range(len(rs))]
    assert len(tds.ProcessShard(got_ds)) == len(got_ds)      # no process group: 0 of 1
    with pytest.raises(ValueError):
        tds.ProcessShard(got_ds, 3, 3)


def test_clean_reports_csv_and_vqa_manifest_match_ctpa(tmp_path):
    """clean_reports_csv writes ctpa's bytes (ids as pandas read them, rows
    with nothing left dropped); generate_vqa_manifest writes ctpa's JSONL."""
    src = _write(tmp_path / "in.csv",
                 'impression_id,impressions,site\n'
                 '007,"FINDINGS: x. IMPRESSION: 1. Small nodule, 4 mm. discussed with Dr. A '
                 'at 10:00.",a\n'
                 '8,"IMPRESSION: Pulmonary embolism <date>.\nEND OF IMPRESSION: trailer",\n'
                 '9,no impression here,c\n10,NA,d\n')
    trep.clean_reports_csv(src, str(tmp_path / "port.csv"))
    jrep.clean_reports_csv(src, str(tmp_path / "ctpa.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ctpa.csv").read_bytes()
    data = _npz_tree(tmp_path / "img", ["7", "8", "9"])
    for mod, out in ((tman, "port.jsonl"), (jman, "ctpa.jsonl")):
        mod.generate_vqa_manifest(src, os.path.join(data, "shard_0"), str(tmp_path / out))
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ctpa.jsonl").read_bytes()
    assert tman.read_jsonl(str(tmp_path / "port.jsonl")) == jman.read_jsonl(
        str(tmp_path / "ctpa.jsonl"))


def test_write_csv_matches_to_csv(tmp_path):
    """write_csv writes DataFrame(rows).to_csv(index=False)'s bytes: floats in
    repr form, ints, bools, lists, missing keys and None, quoting."""
    rows = [{"a": 1, "b": 0.1, "c": [0.75, 0.75], "d": True, "e": 'say "hi", then\nbye'},
            {"a": 2, "b": 1e20, "c": None, "d": False, "f": 3},
            {"a": 3, "b": float("nan"), "c": "x", "d": True, "e": None, "f": 0.699999988079071}]
    path = str(tmp_path / "port.csv")
    tman.write_csv(path, rows)
    buf = io.StringIO()
    pd.DataFrame(rows).to_csv(buf, index=False)
    assert open(path).read() == buf.getvalue()


def _metadata_sources(root):
    """Two NIfTI volumes (one gzipped, slope 0 -> 1.0) and one DICOM series."""
    rng = np.random.default_rng(50)
    raw = root / "raw"
    raw.mkdir()
    nifti.save(str(raw / "scan_b.nii.gz"), rng.integers(0, 2000, (40, 36, 12), dtype=np.int16),
               spacing=(0.7, 0.7, 2.0), scl_slope=0.0, scl_inter=-1024.0)
    nifti.save(str(raw / "scan_a.nii"), rng.integers(0, 2000, (36, 40, 14), dtype=np.int16),
               spacing=(0.75, 0.8, 1.5), scl_slope=1.0, scl_inter=-1000.0)
    dicom.save_series(str(raw / "series_c"), rng.integers(0, 2000, (10, 32, 36), dtype=np.int16),
                      spacing=(2.5, 0.8, 0.8), slope=1.0, intercept=-1024.0, shuffle=True)
    return raw


@pytest.mark.parametrize("train_frac", [0.8, 0.34])
def test_write_split_metadata_bytes_match_ctpa(tmp_path, train_frac):
    raw = _metadata_sources(tmp_path)
    files = tpre_cli.find_nii_files(str(raw))
    series = tpre_cli.find_dicom_series(str(raw))
    assert files == jpre_cli.find_nii_files(str(raw))
    assert series == jpre_cli.find_dicom_series(str(raw))
    rows = tman.extract_metadata(files) + tman.extract_metadata_dicom(series)
    df = pd.concat([jman.extract_metadata(files), jman.extract_metadata_dicom(series)],
                   ignore_index=True)
    assert rows == df.to_dict("records")
    got = tman.write_split_metadata(rows, str(tmp_path / "port"), train_frac, seed=3)
    ref = jman.write_split_metadata(df, str(tmp_path / "ctpa"), train_frac, seed=3)
    for a, b in zip(got, ref):
        assert open(a, "rb").read() == open(b, "rb").read(), os.path.basename(a)


# ---------------------------------------------------------- classification

def _scores(seed, n=40, labels=3, ties=True):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(n, labels)) < 0.4).astype(np.float32)
    s = rng.uniform(size=(n, labels)) + 0.5 * y
    if ties:
        s = np.round(s, 1)          # many tied scores, across both classes
    return s.astype(np.float32), y


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_roc_auc_and_roc_curve_match_sklearn(seed):
    from sklearn import metrics as skm

    s, y = _scores(seed, ties=seed % 2 == 0)
    for i in range(y.shape[1]):
        assert abs(tcls.roc_auc(y[:, i], s[:, i]) - skm.roc_auc_score(y[:, i], s[:, i])) <= EXACT
        for got, ref in zip(tcls.roc_curve(y[:, i], s[:, i]), skm.roc_curve(y[:, i], s[:, i])):
            np.testing.assert_array_equal(got, ref)
        for got, ref in zip(tcls.precision_recall_curve(y[:, i], s[:, i]),
                            skm.precision_recall_curve(y[:, i], s[:, i])):
            np.testing.assert_array_equal(got, ref)
    one_class = np.zeros(len(y))
    assert np.isnan(tcls.roc_auc(one_class, s[:, 0]))
    assert np.isnan(jcls.roc_auc(one_class, s[:, 0]))


@pytest.mark.parametrize("seed", [4, 5])
def test_bootstrap_youden_and_evaluation_match_ctpa(tmp_path, seed, capsys, monkeypatch):
    s, y = _scores(seed, n=12, labels=4)
    y[:, 3] = 0.0                   # one class: NaN everywhere
    names = ["A", "B c", "D", "E"]
    ref = jcls.bootstrap_cis(s, y, names, n_samples=200, seed=seed)
    got = tcls.bootstrap_cis(s, y, names, n_samples=200, seed=seed)
    assert list(got) == list(ref.columns) and got["label"] == list(ref["label"])
    for c in ("lower", "mid", "upper"):
        np.testing.assert_allclose(got[c], ref[c].to_numpy(), atol=EXACT, rtol=0)
    ref = jcls.accuracy_f1_at_youden(s, y, names)
    got = tcls.accuracy_f1_at_youden(s, y, names)
    assert list(got) == list(ref.columns)
    for c in ("accuracy", "f1", "precision", "recall"):
        np.testing.assert_allclose(got[c], ref[c].to_numpy(), atol=EXACT, rtol=0)
    ref = jcls.evaluate_classification(s, y, names)
    got = tcls.evaluate_classification(s, y, names, plot_dir=str(tmp_path / "plots"))
    assert list(got) == list(ref.columns)
    np.testing.assert_allclose([v[0] for v in got.values()], ref.iloc[0].to_numpy(), atol=EXACT)
    assert sorted(os.listdir(tmp_path / "plots")) == ["A_roc_pr.png", "B_c_roc_pr.png",
                                                      "D_roc_pr.png"]
    # where matplotlib is missing (the card) the plots are skipped, said so
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    again = tcls.evaluate_classification(s, y, names, plot_dir=str(tmp_path / "none"))
    assert list(again) == list(got) and all(_same(again[k][0], got[k][0]) for k in got)
    assert not os.path.exists(tmp_path / "none")
    assert "matplotlib is not installed" in capsys.readouterr().err


def test_nlg_results_and_visualization_match_ctpa(tmp_path, monkeypatch, capsys):
    from ctpa.eval import artifacts as jart

    records = [{"id": "a", "bleu": 0.5, "text": "x, y"}, {"id": "b", "bleu": None, "extra": 2}]
    got = tart.write_nlg_results(str(tmp_path / "port"), records, {"bleu": 0.25})
    ref = jart.write_nlg_results(str(tmp_path / "ctpa"), records, {"bleu": 0.25})
    for k in ("json", "csv"):
        assert open(got[k], "rb").read() == open(ref[k], "rb").read(), k
    vol = np.random.default_rng(51).normal(size=(1, 6, 8, 10)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tart.visualize_sample(str(tmp_path / "vis"), vol, "p", "r", "q", "s1")
    assert os.listdir(tmp_path / "vis") == ["s1_text.txt"]
    assert "matplotlib is not installed" in capsys.readouterr().err


# ------------------------------------------------------------------ CLIs

def test_preprocess_cli_matches_ctpa(tmp_path):
    """NIfTI files and a DICOM series through both CLIs: the npz files within
    ATOL, the metadata CSVs byte-equal."""
    raw = _metadata_sources(tmp_path)
    argv = ["--input-dir", str(raw), "--split", "valid", "--target-shape", "12", "24", "20",
            "--window", "inference"]
    tpre_cli.main(argv + ["--output-dir", str(tmp_path / "port")], device="cpu")
    jpre_cli.main(argv + ["--output-dir", str(tmp_path / "ctpa")])
    walk = {d: sorted(os.path.relpath(os.path.join(r, f), tmp_path / d)
                      for r, _, fs in os.walk(tmp_path / d) for f in fs) for d in ("port", "ctpa")}
    assert walk["port"] == walk["ctpa"] and len(walk["port"]) == 5
    for rel in walk["port"]:
        a, b = tmp_path / "port" / rel, tmp_path / "ctpa" / rel
        if rel.endswith(".csv"):
            assert a.read_bytes() == b.read_bytes(), rel
        else:
            got, ref = np.load(a)["arr_0"], np.load(b)["arr_0"]
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (12, 24, 20)
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=rel)


VIT, BERT = tc.CTViTConfig.tiny(), tc.BertConfig.tiny()
GAINS = {"gamma", "scale", "q_scale", "k_scale", "norm_in_scale"}


def _np_params(tree, seed):
    """Numpy draws for a flax param tree: gains near 1, Dense kernels at
    1/sqrt(fan_in), the rest at 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name in GAINS or name == "temperature":
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        if name.endswith("kernel") and len(shape) == 2:
            return np.asarray(rng.normal(size=shape) / np.sqrt(shape[0]), np.float32)
        return np.asarray(0.1 * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def test_zeroshot_cli_matches_ctpa_run_zeroshot(tmp_path, capsys, monkeypatch):
    """ctpa's tiny CTCLIP weights, carried into the port and saved with the
    port's CheckpointManager; 6 npz volumes (and one without labels): the
    port's main(--tiny) against ctpa's run_zeroshot on the same files."""
    jvit = jc.CTViTConfig(**{f.name: getattr(VIT, f.name) for f in dataclasses.fields(VIT)})
    jbert = jc.BertConfig(**{f.name: getattr(BERT, f.name) for f in dataclasses.fields(BERT)})
    jm = JCLIP(jc.CTCLIPConfig.tiny(jvit, jbert), jvit, jbert)
    ids = np.ones((1, 8), np.int32)
    video = np.zeros((1, 1, VIT.temporal_size, VIT.image_size, VIT.image_size), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), ids, ids, video))["params"]
    params = _np_params(shapes, 52)
    rng = np.random.default_rng(53)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    vq = {"codebook": cb, "cluster_size": np.zeros(VIT.codebook_size, np.float32),
          "embed_avg": cb.copy()}
    model = load_flax_params(CTCLIP(tc.CTCLIPConfig.tiny(VIT, BERT), VIT, BERT, device="cpu"),
                             params)
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(3, {"params": model.state_dict(),
                                     "vq_state": {k: torch.from_numpy(v) for k, v in vq.items()},
                                     "step": 3})

    names = [f"vol_{i}" for i in range(7)]
    data = tmp_path / "data"
    for i, name in enumerate(names):
        sub = data / f"valid_{name[:2]}" / f"valid_{name}"
        sub.mkdir(parents=True)
        np.savez(sub / f"{name}.npz",
                 rng.uniform(-1.1, 1.1, size=(36, 30, 18 + 2 * (i % 2))).astype(np.float32))
    reports = _write(tmp_path / "reports.csv", "impression_id,impressions\n" + "".join(
        f'{n},"Report {n}, plain."\n' for n in names))
    onehot = (np.add.outer(np.arange(6), np.arange(len(PATHOLOGIES))) % 2
              + (np.arange(6)[:, None] == 0)) % 2
    labels = _write(tmp_path / "labels.csv", "VolumeName," + ",".join(PATHOLOGIES) + "\n" + "".join(
        f"{n}," + ",".join(str(v) for v in row) + "\n" for n, row in zip(names[:6], onehot)))

    monkeypatch.setitem(sys.modules, "matplotlib", None)      # as on the card
    out = str(tmp_path / "port")
    assert tzs_cli.main(["--data-dir", str(data), "--reports-csv", reports, "--labels-csv",
                         labels, "--checkpoint-dir", ckpt, "--out-dir", out, "--tiny",
                         "--batch-size", "4"], device="cpu") == 0
    err = capsys.readouterr().err
    assert "matplotlib is not installed" in err and "'n': 6" in err
    monkeypatch.delitem(sys.modules, "matplotlib")

    # ctpa's library entry (its main writes a compilation cache into the
    # repository); its plots are not compared
    monkeypatch.setattr(jcls, "_plot_roc_pr", lambda *a: None)
    ref_out = str(tmp_path / "ctpa")
    grid = (VIT.temporal_size, VIT.image_size, VIT.image_size)
    ref = jzs_cli.run_zeroshot(
        jm, {"params": params}, JVQState(**{k: jnp.asarray(v) for k, v in vq.items()}),
        jds.CTReportInferenceDataset(str(data), reports, labels, PATHOLOGIES),
        JTok(vocab_size=BERT.vocab_size, max_length=min(512, BERT.max_position_embeddings)),
        ref_out, pre_cfg=dataclasses.replace(jc.PreprocessConfig.inference(), target_shape=grid),
        batch_size=4)
    assert ref["n"] == 6

    def npz(d, f):
        return np.load(os.path.join(d, f))["data"]

    np.testing.assert_allclose(npz(out, "predicted_weights.npz"),
                               npz(ref_out, "predicted_weights.npz"), atol=1e-5)
    np.testing.assert_array_equal(npz(out, "labels_weights.npz"),
                                  npz(ref_out, "labels_weights.npz"))
    assert open(os.path.join(out, "accessions.txt")).read() == open(
        os.path.join(ref_out, "accessions.txt")).read()
    for name in ("aurocs.csv", "bootstrap_cis.csv"):
        got, want = pd.read_csv(os.path.join(out, name)), pd.read_csv(os.path.join(ref_out, name))
        assert list(got.columns) == list(want.columns)
        for c in got.columns:
            if got[c].dtype.kind == "f":
                np.testing.assert_allclose(got[c], want[c], atol=1e-5, err_msg=name)
            else:
                assert list(got[c]) == list(want[c])
    assert sorted(os.listdir(out)) == ["accessions.txt", "aurocs.csv", "bootstrap_cis.csv",
                                       "labels_weights.npz", "predicted_weights.npz"]


def test_zeroshot_cli_without_checkpoint_returns_1(tmp_path, capsys):
    assert tzs_cli.main(["--data-dir", str(tmp_path), "--reports-csv", "r", "--labels-csv", "l",
                         "--checkpoint-dir", str(tmp_path / "empty"), "--tiny"],
                        device="cpu") == 1
    assert "no checkpoint found" in capsys.readouterr().err
