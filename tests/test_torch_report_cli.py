"""The port's report workload from files against ctpa's, on the CPU: the
``train_report``, ``generate_report`` and ``evaluate`` CLIs end to end on
JSONL manifests and npz volumes the tests write from a seed, with the tiny
configurations.

Both packages start from the same weights: ctpa's tiny report generator's
parameter shapes filled from numpy, given to ctpa's ``train_report.main``
through its model's ``init`` and to the port's through ``init_params`` (a
test-side seam, no CLI flag).  Each package then generates from its own
checkpoint directory.

Tolerances: the per-step losses and gradient norms within 1e-5 (fp32 on
both sides, sums in another order); the checkpoints' steps and kinds, the
greedy predictions of every tier and their NLG metrics equal; the printed
JSON of ``evaluate`` equal and its CSVs byte for byte, but where BERTScore
comes from a BERT snapshot (flax and torch encoders in fp32), within 1e-6.
"""

import json
import os
import shutil
import struct

import jax
import numpy as np
import pytest
import torch

from ctpa.cli import evaluate as jev_cli
from ctpa.cli import export_serving as jexp_cli
from ctpa.cli import generate_report as jgen_cli
from ctpa.cli import train_report as jtr_cli
from ctpa.core import compilation_cache as jcache
from ctpa.core import config as jc
from ctpa.models import report_generator as jrg
from ctpa_torch.cli import evaluate as tev_cli
from ctpa_torch.cli import export_serving as texp_cli
from ctpa_torch.cli import generate_report as tgen_cli
from ctpa_torch.cli import train_report as ttr_cli
from ctpa_torch.convert import load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.eval.zeroshot import PATHOLOGIES
from ctpa_torch.models.report_generator import CTReportGenerator

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
LORA = ["--lora-rank", "4", "--lora-alpha", "8"]
WORDS = ("the lung is clear no nodule pleural effusion small opacity right left lobe "
         "pulmonary embolism present").split()
VIT = tc.CTViTConfig.tiny()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """4 training items, 1 validation item and 3 generation items: npz
    volumes (16, 32, 32) and ReportGenDataset JSONL manifests."""
    root = tmp_path_factory.mktemp("report_files")
    rng = np.random.default_rng(60)
    rows = []
    for i in range(8):
        path = str(root / f"vol_{i}.npz")
        np.savez(path, rng.uniform(-1, 1, size=(VIT.temporal_size, VIT.image_size,
                                                 VIT.image_size)).astype(np.float32))
        rows.append({"image_path": path,
                     "report": " ".join(rng.choice(WORDS, size=int(rng.integers(4, 14))))})
    for name, part in (("train", rows[:4]), ("val", rows[4:5]), ("gen", rows[5:])):
        with open(root / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in part)
    return root


def _start_params():
    """ctpa's tiny report generator with LoRA rank 4, its parameters filled
    from a seed (LoRA B at 0.05, so the adapters move the logits)."""
    lora = jc.LoRAConfig(rank=4, alpha=8.0)
    jm = jrg.CTReportGenerator(jc.LLMConfig.tiny(), jc.CTViTConfig.tiny(),
                               jc.ReportGenConfig(lora=lora), lora=lora)
    video = np.zeros((1, 1, VIT.temporal_size, VIT.image_size, VIT.image_size), np.float32)
    ids = np.ones((1, 8), np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), video, ids, ids))["params"]
    rng = np.random.default_rng(61)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight", "norm_in_scale"):
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        std = 0.05 if name == "lora_b" else 0.1
        return np.asarray(std * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def trained(files, tmp_path_factory):
    """train_report.main --tiny of both packages, 2 epochs of 2 steps, from
    the same weights: -> {package: (checkpoint dir, results dir)}, and the
    starting weights."""
    params = _start_params()
    out = tmp_path_factory.mktemp("trained")

    class Seeded(jrg.CTReportGenerator):
        def init(self, *args, **kwargs):
            return {"params": params}

    def port_init(model, seed=0):
        return load_flax_params(model, params)

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        # ctpa's CLIs point JAX's compilation cache into the repository
        mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
        mp.setattr(jtr_cli, "CTReportGenerator", Seeded)
        mp.setattr(ttr_cli, "init_params", port_init)
        for name, main in (("ctpa", jtr_cli.main),
                           ("port", lambda argv: ttr_cli.main(argv, device="cpu"))):
            ckpt, res = str(out / name / "ckpt"), str(out / name / "results")
            assert main(["--train-jsonl", str(files / "train.jsonl"), "--val-jsonl",
                         str(files / "val.jsonl"), "--tiny", "--epochs", "2", "--max-length",
                         "24", "--checkpoint-dir", ckpt, "--results-dir", res, *LORA]) == 0
            runs[name] = (ckpt, res)
    return runs, params


def test_train_report_tiny_matches_ctpa(trained):
    """Per-step losses and gradient norms within 1e-5, the same validation
    scores, and checkpoints of the same steps and kinds."""
    runs, _ = trained
    hist = {}
    for name, (_, res) in runs.items():
        with open(os.path.join(res, "report_train_metrics.json")) as f:
            hist[name] = json.load(f)["metrics"]
    assert sorted(hist["port"]) == sorted(hist["ctpa"])
    for key, series in hist["ctpa"].items():
        got = hist["port"][key]
        assert [s for s, _ in got] == [s for s, _ in series], key
        np.testing.assert_allclose([v for _, v in got], [v for _, v in series],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    assert [s for s, _ in hist["port"]["loss"]] == [1, 2, 3, 4]
    from ctpa.core.checkpoint import CheckpointManager as JManager

    jm, tm = JManager(runs["ctpa"][0]), CheckpointManager(runs["port"][0])
    assert tm.all_steps() == list(jm.all_steps()) and tm.all_steps()
    for step in tm.all_steps():
        assert tm.restore_metadata(step)["kind"] == jm.restore_metadata(step)["kind"], step


def test_train_report_checkpoint_restores_the_frozen_base(trained, tmp_path):
    """The port's run wrote its frozen base once (base.pt) beside steps that
    hold the trained tensors only; base and the latest step together are the
    whole model, and the base is the starting weights.  A copy of the
    directory without base.pt makes generate_report raise, naming it."""
    runs, params = trained
    ckpt = runs["port"][0]
    base = torch.load(os.path.join(ckpt, "base.pt"), weights_only=True)
    mgr = CheckpointManager(ckpt)
    step = mgr.restore()["params"]
    lora = tc.LoRAConfig(rank=4, alpha=8.0)
    start = load_flax_params(CTReportGenerator(tc.LLMConfig.tiny(), VIT,
                                               tc.ReportGenConfig(lora=lora), lora=lora,
                                               device="cpu"), params).state_dict()
    assert not set(base) & set(step) and set(base) | set(step) == set(start)
    assert all("lora_" in k or "cross_attention" in k for k in step)
    for key, value in base.items():
        assert torch.equal(value, start[key]), key
    assert sorted(os.listdir(ckpt)) == sorted(["base.pt"] + [str(s) for s in mgr.all_steps()])
    bare = tmp_path / "no_base"
    shutil.copytree(ckpt, bare)
    os.remove(bare / "base.pt")
    with pytest.raises(FileNotFoundError, match="base.pt"):
        tgen_cli.main(["--jsonl", "unused.jsonl", "--checkpoint-dir", str(bare), "--tiny",
                       *LORA], device="cpu")


def test_train_report_full_width_branch(trained, files, tmp_path, monkeypatch):
    """train_report and generate_report without --tiny, their LLMConfig()
    and CTViTConfig() (and the inference grid) replaced by the tiny ones (a
    test-side seam): build_model's full-width branch, the partitioned step
    and the checkpoint layout they give.  base.pt holds the frozen base in
    bf16 and each step the trainable tensors (LoRA, cross-attention) in
    fp32; together, and only together, they are the model's state_dict.
    Its two losses, computed in bf16 (the second after one partitioned
    step), lie within 1e-3 of the fp32 --tiny run's first two from the same
    weights (5e-5 on the CPU), and generate_report restores the directory and
    decodes."""
    import dataclasses

    runs, params = trained
    monkeypatch.setattr(ttr_cli, "init_params", lambda model, seed=0: load_flax_params(model,
                                                                                       params))
    grid = dataclasses.replace(tc.PreprocessConfig.inference(),
                               target_shape=(VIT.temporal_size, VIT.image_size, VIT.image_size))
    for cli in (ttr_cli, tgen_cli):
        monkeypatch.setattr(cli, "LLMConfig", tc.LLMConfig.tiny)
        monkeypatch.setattr(cli, "CTViTConfig", tc.CTViTConfig.tiny)
    monkeypatch.setattr(tc.PreprocessConfig, "inference", staticmethod(lambda: grid))
    ckpt, res = str(tmp_path / "ckpt"), str(tmp_path / "res")
    assert ttr_cli.main(["--train-jsonl", str(files / "train.jsonl"), "--epochs", "1",
                         "--max-length", "24", "--checkpoint-dir", ckpt, "--results-dir", res,
                         *LORA], device="cpu") == 0
    base = torch.load(os.path.join(ckpt, "base.pt"), weights_only=True)
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps()
    lora = tc.LoRAConfig(rank=4, alpha=8.0)
    own = CTReportGenerator(tc.LLMConfig.tiny(), VIT, tc.ReportGenConfig(lora=lora), lora=lora,
                            device="cpu").state_dict()
    for step in mgr.all_steps():
        trained_part = mgr.restore(step)["params"]
        assert trained_part and all(v.dtype == torch.float32 for v in trained_part.values())
        assert all("lora_" in k or "cross_attention" in k for k in trained_part)
        assert not set(base) & set(trained_part)
        assert set(base) | set(trained_part) == set(own)
    assert all(v.dtype == torch.bfloat16 for v in base.values() if v.is_floating_point())
    losses = {}
    for name, path in (("full", res), ("tiny", runs["port"][1])):
        with open(os.path.join(path, "report_train_metrics.json")) as f:
            losses[name] = json.load(f)["metrics"]["loss"]
    assert [s for s, _ in losses["full"]] == [s for s, _ in losses["tiny"][:2]] == [1, 2]
    np.testing.assert_allclose([v for _, v in losses["full"]],
                               [v for _, v in losses["tiny"][:2]], rtol=1e-3)
    out = tmp_path / "gen"
    assert tgen_cli.main(["--jsonl", str(files / "gen.jsonl"), "--checkpoint-dir", ckpt,
                          "--greedy", "--max-new-tokens", "4", "--num-lanes", "2", *LORA,
                          "--out-dir", str(out)], device="cpu") == 0
    samples, _ = _records(out)
    assert len(samples) == 3 and all(r["tokens"] > 0 for r in samples)


def _records(out_dir):
    with open(os.path.join(out_dir, "evaluation_results.json")) as f:
        payload = json.load(f)
    samples = [{k: v for k, v in r.items() if k != "latency_s"} for r in payload["samples"]]
    return samples, payload["metrics"]


TIERS = {"batcher": ["--visualize"], "speculative": ["--speculative", "3"],
         "spec-serve": ["--spec-serve", "3"]}


@pytest.mark.parametrize("tier", list(TIERS))
def test_generate_report_tiny_matches_ctpa(trained, files, tmp_path, monkeypatch, tier):
    """Each package's generate_report --tiny --greedy from its own checkpoint
    directory: the same predictions, token counts, verify steps and
    metrics, for the batcher, the --speculative tier and the --spec-serve
    tier."""
    runs, _ = trained
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
    argv = ["--jsonl", str(files / "gen.jsonl"), "--tiny", "--greedy", "--max-new-tokens", "6",
            "--num-lanes", "2", *LORA, *TIERS[tier]]
    assert jgen_cli.main(argv + ["--checkpoint-dir", runs["ctpa"][0], "--out-dir",
                                 str(tmp_path / "ctpa")]) == 0
    assert tgen_cli.main(argv + ["--checkpoint-dir", runs["port"][0], "--out-dir",
                                 str(tmp_path / "port")], device="cpu") == 0
    got, ref = _records(tmp_path / "port"), _records(tmp_path / "ctpa")
    assert got == ref
    assert len(got[0]) == 3 and all(r["tokens"] > 0 for r in got[0])
    listing = sorted(os.listdir(tmp_path / "port"))
    assert listing == sorted(os.listdir(tmp_path / "ctpa"))
    if tier == "batcher":                # --visualize: the per-sample text files
        assert listing == ["evaluation_results.csv", "evaluation_results.json", "viz"]
        for i in range(3):
            name = os.path.join("viz", f"sample_{i}_text.txt")
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "ctpa" / name).read_text()


def test_generate_report_bundle_matches_ctpa(trained, files, tmp_path, monkeypatch):
    """Each package's checkpoint through its export_serving.main (int8,
    fused FFN, w8a8, int8 KV cache; the port's reading base.pt) and
    generate_report --serving-bundle: the same greedy predictions as ctpa's
    with the port computing in fp32 as ctpa does (the bound of the port's
    quantized generate tests), on ctpa's plain composition (xla) and on the
    kernels' plain versions alike."""
    runs, _ = trained
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
    monkeypatch.setattr(tgen_cli, "QUANT_COMPUTE_DTYPE", torch.float32)
    flags = ["--quant", "int8", "--ffn-kernel", "--act-quant", "--kv-quant", "int8", *LORA]
    assert jexp_cli.main(["--checkpoint-dir", runs["ctpa"][0], "--out",
                          str(tmp_path / "jb"), *flags]) == 0
    assert texp_cli.main(["--checkpoint-dir", runs["port"][0], "--out", str(tmp_path / "tb"),
                          "--device", "cpu", *flags]) == 0
    argv = ["--jsonl", str(files / "gen.jsonl"), "--tiny", "--greedy", "--max-new-tokens", "6",
            "--num-lanes", "2"]
    assert jgen_cli.main(argv + ["--serving-bundle", str(tmp_path / "jb"), "--quant-impl", "xla",
                                 "--out-dir", str(tmp_path / "ctpa")]) == 0
    ref = _records(tmp_path / "ctpa")
    for impl in ("xla", "pallas"):
        out = str(tmp_path / f"port_{impl}")
        assert tgen_cli.main(argv + ["--serving-bundle", str(tmp_path / "tb"), "--quant-impl",
                                     impl, "--out-dir", out], device="cpu") == 0
        assert _records(out) == ref, impl


# two packages' greedy tokens from quantized weights that may differ in a
# level here and there: each step's token within this share of max |logit|
# of that step's top logit (the w4a8 logit bound of tests/test_torch_quant.py)
QUANT_TIE = 0.02


def _recording(cls, decoded):
    class Recording(cls):
        def decode(self, ids):
            decoded.append([int(i) for i in ids])
            return super().decode(ids)

    return Recording


@pytest.mark.parametrize("quant", [["--quant", "int8", "--act-quant"], ["--quant", "int4"]],
                         ids=["int8-act", "int4"])
def test_generate_report_quant_matches_ctpa(trained, files, tmp_path, monkeypatch, quant):
    """generate_report --quant on each package's checkpoint directory (the
    port's base.pt and latest step; the LoRA deltas merged, the projections
    quantized), w8a8 and int4 weight-only, the port computing in fp32 as
    ctpa does, on ctpa's plain composition (xla) and on the kernels' plain
    versions.  The packages' checkpoints differ in their last fp32 bits
    (each trained its own), and their merges round A @ B otherwise, which
    moves an int8 level or a nibble here and there (tests/test_torch_quant.py),
    so their greedy tokens may part at a near tie: both packages' tokens,
    teacher-forced through the port's model, are at every step within
    QUANT_TIE of max |logit| of that step's top logit; the records are
    otherwise equal."""
    import dataclasses

    import chip_smoke as cs
    from ctpa.data import tokenizer as jtok
    from ctpa_torch.core.checkpoint import load_base
    from ctpa_torch.data import tokenizer as ttok
    from ctpa_torch.data.datasets import ReportGenDataset
    from ctpa_torch.ops.preprocess import preprocess_volume_inference

    runs, _ = trained
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
    monkeypatch.setattr(tgen_cli, "QUANT_COMPUTE_DTYPE", torch.float32)
    argv = ["--jsonl", str(files / "gen.jsonl"), "--tiny", "--greedy", "--max-new-tokens", "6",
            "--num-lanes", "2", *LORA, *quant]
    decoded = {"ctpa": []}
    monkeypatch.setattr(jgen_cli, "SimpleWordTokenizer",
                        _recording(jtok.SimpleWordTokenizer, decoded["ctpa"]))
    assert jgen_cli.main(argv + ["--checkpoint-dir", runs["ctpa"][0], "--quant-impl", "xla",
                                 "--out-dir", str(tmp_path / "ctpa")]) == 0
    ref = _records(tmp_path / "ctpa")
    keys = ("id", "prompt", "reference")
    items = [ReportGenDataset(str(files / "gen.jsonl"))[i] for i in range(3)]
    video = torch.stack([preprocess_volume_inference(
        it["volume"], tc.PreprocessConfig(target_shape=(16, 32, 32)), device="cpu")
        for it in items])
    toks = ttok.SimpleWordTokenizer(vocab_size=512)([it["prompt"] for it in items],
                                                    max_length=64)
    ids, mask = (torch.as_tensor(toks[k]).long() for k in ("input_ids", "attention_mask"))
    params = load_base(runs["port"][0])
    params.update(CheckpointManager(runs["port"][0]).restore()["params"])
    for impl in ("xla", "pallas"):
        out = str(tmp_path / f"port_{impl}")
        decoded[impl] = []
        monkeypatch.setattr(tgen_cli, "SimpleWordTokenizer",
                            _recording(ttok.SimpleWordTokenizer, decoded[impl]))
        assert tgen_cli.main(argv + ["--checkpoint-dir", runs["port"][0], "--quant-impl", impl,
                                     "--out-dir", out], device="cpu") == 0
        got = _records(out)
        assert [[r[k] for k in keys] for r in got[0]] == [[r[k] for k in keys] for r in ref[0]]
        cfg = dataclasses.replace(tc.LLMConfig.tiny(), weight_quant=quant[1],
                                  quant_act="--act-quant" in quant, quant_impl=impl)
        model = tgen_cli.quantized_model(dict(params), cfg, VIT, tc.ReportGenConfig(),
                                         tc.LoRAConfig(rank=4, alpha=8.0))
        for name in ("ctpa", impl):
            assert len(decoded[name]) == 3 and all(decoded[name]), name
            for i, tokens in enumerate(decoded[name]):
                with torch.inference_mode():
                    logits = cs.teacher_forced_logits(model, video[i:i + 1], ids[i:i + 1],
                                                      mask[i:i + 1], torch.tensor([tokens]))[0]
                gap = logits.amax(-1) - logits[torch.arange(len(tokens)), tokens]
                assert (gap <= QUANT_TIE * logits.abs().amax(-1)).all(), (name, i, gap)


def test_generate_report_argument_errors_match_ctpa(trained, capsys):
    """ctpa's argument errors: exit code 2 and the same message."""
    runs, _ = trained
    ckpt = runs["port"][0]
    cases = [["--checkpoint-dir", ckpt, "--act-quant"],
             ["--checkpoint-dir", ckpt, "--speculative", "2", "--spec-serve", "2"],
             [],
             ["--checkpoint-dir", ckpt, "--serving-bundle", ckpt],
             ["--serving-bundle", ckpt, "--quant", "int8"],
             ["--serving-bundle", ckpt]]
    for extra in cases:
        for main in (jgen_cli.main, lambda a: tgen_cli.main(a, device="cpu")):
            with pytest.raises(SystemExit) as e:
                main(["--jsonl", "unused.jsonl", "--tiny", *extra])
            assert e.value.code == 2
        err = capsys.readouterr().err.splitlines()
        msgs = [line.split("error: ", 1)[1] for line in err if "error: " in line]
        assert len(msgs) == 2 and msgs[0] == msgs[1], msgs


# ------------------------------------------------------- evaluate

def _nlg_results(root):
    rng = np.random.default_rng(62)
    records = [{"id": i, "reference": " ".join(rng.choice(WORDS, size=int(rng.integers(3, 9)))),
                "prediction": " ".join(rng.choice(WORDS, size=int(rng.integers(0, 9))))}
               for i in range(5)]
    records.append({"id": 5, "reference": "the lung is clear", "prediction": "the lung is clear"})
    with open(root / "results.json", "w") as f:
        json.dump({"metrics": {}, "samples": records}, f)
    from ctpa_torch.data.manifests import write_csv

    write_csv(str(root / "results.csv"), [{**r, "id": float(r["id"])} for r in records])
    return root / "results.json", root / "results.csv"


@pytest.mark.parametrize("source", ["json", "csv"])
def test_evaluate_nlg_matches_ctpa(tmp_path, capsys, source):
    paths = dict(zip(("json", "csv"), _nlg_results(tmp_path)))
    argv = ["nlg", "--results", str(paths[source])]
    assert jev_cli.main(argv) == 0
    ref = capsys.readouterr().out
    assert tev_cli.main(argv, device="cpu") == 0
    assert capsys.readouterr().out == ref
    assert json.loads(ref)["perfect_match"] > 0


def _bert_snapshot(root):
    """A tiny BERT as an HF snapshot: its weights (ctpa's tiny BertEncoder's
    shapes under HF names, seeded) in one BF16 safetensors shard, and a
    WordPiece tokenizer as files (vocab.txt, tokenizer_config.json)."""
    pytest.importorskip("transformers")
    cfg = tc.BertConfig.tiny()
    rng = np.random.default_rng(63)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab_size, h),
              "embeddings.position_embeddings.weight": (cfg.max_position_embeddings, h),
              "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, h),
              "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,)}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            shapes[p + name + ".weight"], shapes[p + name + ".bias"] = (h, h), (h,)
        shapes[p + "intermediate.dense.weight"], shapes[p + "intermediate.dense.bias"] = \
            (inter, h), (inter,)
        shapes[p + "output.dense.weight"], shapes[p + "output.dense.bias"] = (h, inter), (h,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[p + ln + ".weight"], shapes[p + ln + ".bias"] = (h,), (h,)
    header, blobs, offset = {}, [], 0
    for name, shape in shapes.items():
        value = (1 + 0.1 * rng.normal(size=shape) if "LayerNorm.weight" in name
                 else 0.2 * rng.normal(size=shape)).astype(np.float32)
        bits = (value.view(np.uint32) >> 16).astype(np.uint16).tobytes()
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + len(bits)]}
        blobs.append(bits)
        offset += len(bits)
    snap = root / "bert"
    snap.mkdir()
    raw = json.dumps(header).encode()
    with open(snap / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + b"".join(blobs))
    (snap / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WORDS]) + "\n")
    (snap / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    return snap


def test_evaluate_nlg_bertscore_from_a_bf16_snapshot_matches_ctpa(tmp_path, capsys, monkeypatch):
    """BERTScore from a BF16 snapshot of a tiny BERT (the CLIs' BertConfig()
    replaced by the tiny one on both sides): --compute-baseline, then
    --idf with that baseline; the printed numbers within 1e-6 of ctpa's."""
    from ctpa.core import config as jconfig
    from ctpa_torch.core import config as tconfig

    snap = _bert_snapshot(tmp_path)
    jbert = jc.BertConfig(**{k: getattr(tc.BertConfig.tiny(), k)
                             for k in tc.BertConfig.__dataclass_fields__})
    monkeypatch.setattr(jconfig, "BertConfig", lambda: jbert)
    tbert = tc.BertConfig.tiny()
    monkeypatch.setattr(tconfig, "BertConfig", lambda: tbert)
    results, _ = _nlg_results(tmp_path)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(" ".join(WORDS[i:i + 5]) for i in range(0, 12, 2)) + "\n")
    printed = {}
    for name, main in (("ctpa", jev_cli.main),
                       ("port", lambda argv: tev_cli.main(argv, device="cpu"))):
        base = str(tmp_path / f"baseline_{name}.json")
        assert main(["nlg", "--compute-baseline", "--encoder-path", str(snap), "--corpus",
                     str(corpus), "--baseline-out", base, "--idf"]) == 0
        baseline = json.loads(capsys.readouterr().out)
        assert main(["nlg", "--results", str(results), "--encoder-path", str(snap), "--idf",
                     "--baseline", base]) == 0
        printed[name] = (baseline, json.loads(capsys.readouterr().out))
    for got, ref in zip(printed["port"], printed["ctpa"]):
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], atol=1e-6, err_msg=key)
    assert "bertscore_f1" in printed["port"][1]


def test_evaluate_classification_matches_ctpa(tmp_path, capsys):
    """The AUROC table printed as ctpa's DataFrame.to_json() prints it and
    the three CSVs byte for byte; one label holds one class only (NaN)."""
    rng = np.random.default_rng(64)
    n, labels_n = 14, 6
    labels = rng.integers(0, 2, size=(n, labels_n))
    labels[:, 3] = 1
    preds = np.round(rng.random((n, labels_n)), 2).astype(np.float32)
    np.savez(tmp_path / "p.npz", data=preds)
    np.savez(tmp_path / "l.npz", data=labels)
    outs = {}
    for name, main in (("ctpa", jev_cli.main),
                       ("port", lambda argv: tev_cli.main(argv, device="cpu"))):
        csv = str(tmp_path / f"{name}.csv")
        assert main(["classification", "--predictions", str(tmp_path / "p.npz"), "--labels",
                     str(tmp_path / "l.npz"), "--bootstrap", "40", "--out-csv", csv]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["ctpa"] and "null" in outs["port"]
    assert json.loads(outs["port"])[f"{PATHOLOGIES[0]}_auc"]["0"] > 0
    for suffix in (".csv", "_cis.csv", "_operating.csv"):
        got = (tmp_path / f"port{suffix}").read_bytes()
        assert got == (tmp_path / f"ctpa{suffix}").read_bytes(), suffix


def _llama_snapshot(root, cfg):
    """A tiny HF llama state dict, seeded, in one BF16 safetensors shard:
    -> (snapshot dir, its values widened to fp32 by name)."""
    rng = np.random.default_rng(65)
    h, kv = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h), "model.norm.weight": (h,),
              "lm_head.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (h, h), p + "self_attn.k_proj.weight": (kv, h),
                       p + "self_attn.v_proj.weight": (kv, h), p + "self_attn.o_proj.weight": (h, h),
                       p + "mlp.gate_proj.weight": (cfg.intermediate_size, h),
                       p + "mlp.up_proj.weight": (cfg.intermediate_size, h),
                       p + "mlp.down_proj.weight": (h, cfg.intermediate_size),
                       p + "input_layernorm.weight": (h,),
                       p + "post_attention_layernorm.weight": (h,)})
    header, blobs, values, offset = {}, [], {}, 0
    for name, shape in shapes.items():
        bits = ((0.1 * rng.normal(size=shape)).astype(np.float32).view(np.uint32) >> 16)
        values[name] = (bits.astype(np.uint32) << 16).view(np.float32)
        raw = bits.astype(np.uint16).tobytes()
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    snap = root / "llama"
    snap.mkdir()
    text = json.dumps(header).encode()
    (snap / "model.safetensors").write_bytes(struct.pack("<Q", len(text)) + text + b"".join(blobs))
    return snap, values


def test_train_report_llm_weights_from_a_bf16_snapshot(files, tmp_path):
    """--llm-weights: a BF16 llama snapshot grafted onto the LLM before
    training; the frozen base the run writes holds the snapshot's values,
    widened exactly, under the port's names (the LoRA adapters and the
    cross-attention are not in a snapshot)."""
    snap, values = _llama_snapshot(tmp_path, tc.LLMConfig.tiny())
    ckpt = str(tmp_path / "ckpt")
    assert ttr_cli.main(["--train-jsonl", str(files / "train.jsonl"), "--tiny", "--epochs", "1",
                         "--max-length", "24", "--llm-weights", str(snap), "--checkpoint-dir",
                         ckpt, "--results-dir", str(tmp_path / "res"), *LORA],
                        device="cpu") == 0
    base = torch.load(os.path.join(ckpt, "base.pt"), weights_only=True)
    for name, value in values.items():
        key = "llm." + name.replace("self_attn.q_proj.weight", "self_attn.q_proj.base.weight")
        for proj in ("k", "v", "o"):
            key = key.replace(f"self_attn.{proj}_proj.weight", f"self_attn.{proj}_proj.base.weight")
        assert torch.equal(base[key], torch.from_numpy(value)), key


def test_overlay_release_frees_each_leaf():
    """overlay_flax_params loads an import as load_flax_params (strict)
    loads it, and leaves no array in the imported tree."""
    from ctpa_torch.convert import overlay_flax_params
    from ctpa_torch.data.hf_import import import_llama
    from ctpa_torch.models.llm import LlamaForCausalLM

    cfg = tc.LLMConfig.tiny()
    rng = np.random.default_rng(66)
    sd = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in LlamaForCausalLM(cfg, device="cpu").state_dict().items()}
    hf = {("model." + k if not k.startswith("lm_head") else k).replace(".base.", "."): v
          for k, v in sd.items()}
    hf = {k.replace("model.model.", "model."): v for k, v in hf.items()}
    strict = load_flax_params(LlamaForCausalLM(cfg, device="cpu"), import_llama(hf, cfg))
    tree = import_llama(hf, cfg)
    grafted = LlamaForCausalLM(cfg, device="cpu")
    assert overlay_flax_params(grafted, tree) == []
    assert jax.tree_util.tree_leaves(tree) == []
    for (name, a), b in zip(strict.state_dict().items(), grafted.state_dict().values()):
        assert torch.equal(a, b), name
