"""The port's CT-CLIP training CLI against ctpa's, on the CPU: both packages'
``train_clip.main --tiny`` on the same npz volumes and CSVs (raw int16
training volumes with their metadata, pre-normalised validation volumes
with labels), from the same weights, with the periodic zero-shot eval, the
checkpoints and ``--resume``; and the port's ``PrefetchIterator``.

Both packages start from the same weights: ctpa's tiny CTCLIP's parameter
shapes filled from numpy, given to ctpa's CLI through its model's ``init``
and to the port's through ``init_state`` (a test-side seam, no CLI flag),
with ctpa's VQ codebook of ``vq_init(key(0))`` on both sides.  ctpa's mesh is
one device (the test process has eight virtual ones, and the batch is 2).

Tolerances: the per-step loss, grad_norm, temperature and vq_commit within
1e-5 relative (fp32 on both sides, sums in another order; the video rounded
to bf16 on both, as ctpa's CLI trains an fp32 model under the bf16 policy);
the eval's predictions within 1e-5 and its AUROC table equal; checkpoints at
the same steps.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ctpa.cli import train_clip as jtc_cli
from ctpa.core import compilation_cache as jcache
from ctpa.core import config as jc
from ctpa.core.checkpoint import CheckpointManager as JManager
from ctpa.core.mesh import single_device_mesh
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.ops.vq import vq_init as j_vq_init
from ctpa_torch.cli import train_clip as ttc_cli
from ctpa_torch.convert import load_flax_params, vq_state_from_numpy
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.data.manifests import write_csv
from ctpa_torch.data.prefetch import PrefetchIterator, to_device
from ctpa_torch.eval.zeroshot import PATHOLOGIES

torch.set_num_threads(1)
RTOL = 1e-5
KEYS = ("loss", "grad_norm", "temperature", "vq_commit")
WORDS = "lung nodule effusion clear opacity right left lobe embolism present".split()
RAW = (20, 40, 40)          # (z, y, x) at spacing (2.0, 0.75, 0.75) -> (16, 32, 32)
VALID = (36, 36, 20)        # pre-normalised (h, w, d)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """4 raw int16 training volumes with a metadata CSV, 2 validation
    volumes with labels, one reports CSV for both."""
    root = tmp_path_factory.mktemp("clip_files")
    rng = np.random.default_rng(70)
    for sub in ("train", "valid"):
        os.makedirs(root / sub)
    reports, meta, labels = [], [], []
    for i in range(4):
        name = f"train_{i}"
        np.savez(root / "train" / f"{name}.npz",
                 rng.integers(-1000, 2000, size=RAW).astype(np.int16))
        reports.append({"impression_id": name, "impressions": " ".join(rng.choice(WORDS, 6))})
        meta.append({"VolumeName": f"{name}.nii.gz", "RescaleSlope": 1.0,
                     "RescaleIntercept": -1024.0, "ZSpacing": 2.0, "XYSpacing": 0.75})
    for i in range(2):
        name = f"valid_{i}"
        np.savez(root / "valid" / f"{name}.npz",
                 rng.uniform(-1, 1, size=VALID).astype(np.float32))
        reports.append({"impression_id": name, "impressions": " ".join(rng.choice(WORDS, 6))})
        labels.append({"VolumeName": name, **{p: int((i + j) % 2)
                                              for j, p in enumerate(PATHOLOGIES)}})
    write_csv(str(root / "reports.csv"), reports)
    write_csv(str(root / "meta.csv"), meta)
    write_csv(str(root / "labels.csv"), labels)
    return root


def _args(files, out, steps, *extra):
    return ["--data-dir", str(files / "train"), "--reports-csv", str(files / "reports.csv"),
            "--metadata-csv", str(files / "meta.csv"), "--valid-data-dir", str(files / "valid"),
            "--valid-labels-csv", str(files / "labels.csv"), "--eval-every", "2",
            "--batch-size", "2", "--num-steps", str(steps), "--lr", "0.5", "--tiny",
            "--results-dir", str(out / "results"), "--checkpoint-dir", str(out / "ckpt"), *extra]


def _start():
    """ctpa's tiny CTCLIP parameters filled from a seed, and ctpa's
    vq_init(key(0)) codebook."""
    vit, bert = jc.CTViTConfig.tiny(), jc.BertConfig.tiny()
    model = JCLIP(jc.CTCLIPConfig.tiny(vit, bert), vit, bert)
    vq = j_vq_init(jax.random.key(0), vit.codebook_size, vit.dim)
    ids = np.ones((2, 8), np.int32)
    video = np.zeros((2, 1, vit.temporal_size, vit.image_size, vit.image_size), np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), ids, ids, video, vq))["params"]
    rng = np.random.default_rng(71)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "gamma", "q_scale", "k_scale", "norm_in_scale"):
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        if name == "temperature":
            return np.asarray(1.0, np.float32)
        return np.asarray(0.05 * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes), jax.tree.map(np.asarray, vq)


def _run_both(files, out, steps, params, vq, *extra):
    class Seeded(JCLIP):
        def init(self, *args, **kwargs):
            return {"params": params}

    def port_init(model, seed=0):
        return load_flax_params(model, params), vq_state_from_numpy(vq, device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        # ctpa's CLIs point JAX's compilation cache into the repository
        mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
        mp.setattr(jtc_cli, "CTCLIP", Seeded)
        mp.setattr(jtc_cli, "create_mesh", lambda cfg: single_device_mesh())
        mp.setattr(ttc_cli, "init_state", port_init)
        assert jtc_cli.main(_args(files, out / "ctpa", steps, *extra)) == 0
        assert ttc_cli.main(_args(files, out / "port", steps, *extra), device="cpu") == 0


def _history(run):
    with open(run / "results" / "train_metrics.json") as f:
        return json.load(f)["metrics"]


def _assert_series(got, ref, steps):
    for key in KEYS + ("eval/mean_auc", "eval/n"):
        if key not in ref:
            continue
        assert [s for s, _ in got[key]] == [s for s, _ in ref[key]], key
        np.testing.assert_allclose([v for _, v in got[key]], [v for _, v in ref[key]],
                                   rtol=RTOL, atol=1e-7, err_msg=key)
    assert [s for s, _ in got["loss"]] == steps
    assert set(KEYS) <= set(got) and set(got) == set(ref)


def test_train_clip_tiny_matches_ctpa(files, tmp_path):
    """Both CLIs for 3 steps (eval at step 2), then both again with --resume
    to step 4 (no eval there): per-step metrics within 1e-5, the eval's
    files alike (predictions within 1e-5, the AUROC table equal), and
    checkpoints at the same steps.  One test, so that its two packages'
    four runs are made once under xdist."""
    params, vq = _start()
    _run_both(files, tmp_path, 3, params, vq)
    first = {name: _history(tmp_path / name) for name in ("ctpa", "port")}
    _assert_series(first["port"], first["ctpa"], [1, 2, 3])
    assert [s for s, _ in first["port"]["eval/mean_auc"]] == [2]

    port, ref = (tmp_path / name / "results" / "zeroshot_step2" for name in ("port", "ctpa"))
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    with np.load(port / "labels_weights.npz") as a, np.load(ref / "labels_weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL, atol=1e-6, err_msg=key)
    for name in ("aurocs.csv", "accessions.txt"):
        assert (port / name).read_text() == (ref / name).read_text(), name

    # --resume restores step 3 in both and trains step 4 alike
    _run_both(files, tmp_path, 4, params, vq, "--resume", "--eval-every", "3")
    resumed = {name: _history(tmp_path / name) for name in ("ctpa", "port")}
    _assert_series(resumed["port"], resumed["ctpa"], [4])
    assert CheckpointManager(str(tmp_path / "port" / "ckpt")).all_steps() == \
        JManager(str(tmp_path / "ctpa" / "ckpt")).all_steps() == [3, 4]


@pytest.mark.parametrize("extra", [["--num-processes", "2"], ["--process-id", "0"]])
def test_train_clip_argument_errors_match_ctpa(files, tmp_path, extra):
    """The same exit code as ctpa's for the process flags without a
    coordinator, and for a missing required flag."""
    argv = _args(files, tmp_path, 1, *extra)
    codes = []
    for main in (jtc_cli.main, lambda a: ttc_cli.main(a, device="cpu")):
        for args in (argv, argv[2:]):
            with pytest.raises(SystemExit) as err:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
                    main(args)
            codes.append(err.value.code)
    assert codes == [2, 2, 2, 2]
    # a coordinator needs both process flags (multi-process training is
    # ported: tests/test_torch_parallel.py)
    with pytest.raises(SystemExit) as err:
        ttc_cli.main(_args(files, tmp_path, 1, "--coordinator", "localhost:1", *extra),
                     device="cpu")
    assert err.value.code == 2


# ------------------------------------------------------------------ prefetch


def test_prefetch_keeps_order_and_stops():
    """Every batch once, in order, under a short thread switch interval;
    then StopIteration (again on a second call) and the worker gone."""
    import sys

    batches = [{"x": np.full((2, 3), i, np.float32), "ids": np.arange(2) + i, "tag": f"b{i}"}
               for i in range(300)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it = PrefetchIterator(iter(batches), device="cpu", depth=2)
        got = list(it)
    finally:
        sys.setswitchinterval(interval)
    assert [b["tag"] for b in got] == [f"b{i}" for i in range(300)]
    for i, b in enumerate(got):
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert torch.equal(b["ids"], torch.arange(2) + i)
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)
    it._thread.join(timeout=10)
    assert not it._thread.is_alive()


def test_prefetch_raises_the_loader_error():
    def source():
        yield {"x": np.zeros(2)}
        raise ValueError("corrupt volume")

    it = PrefetchIterator(source(), device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="corrupt volume"):
        next(it)
    with pytest.raises(ValueError, match="requires a sharding"):
        PrefetchIterator(iter([]), device="cpu", process_local=True)
    assert to_device("text", "cpu") == "text"


# -------------------------------------------------------- logging, profiling


def test_logging_and_profiling_match_ctpa(tmp_path):
    """get_logger's format and handler, log_once, StepTimer's accounting as
    ctpa's; trace writes a Chrome trace and is a no-op without a directory;
    the device memory profile names the missing CUDA device."""
    import logging

    from ctpa.core import logging as jlog
    from ctpa.core import profiling as jprof
    from ctpa_torch.core import logging as tlog
    from ctpa_torch.core import profiling as tprof

    assert tlog._FORMAT == jlog._FORMAT
    logger = tlog.get_logger("ctpa_torch.test")
    assert logger is tlog.get_logger("ctpa_torch.test") and logger.level == logging.INFO
    assert logger.handlers[0].formatter._fmt == jlog._FORMAT
    seen = []
    logger.addHandler(type("H", (logging.Handler,), {"emit": lambda s, r: seen.append(r)})())
    for _ in range(3):
        tlog.log_once(logger, "k", "once")
    assert [r.getMessage() for r in seen] == ["once"]

    timers = []
    for mod in (jprof, tprof):
        with pytest.MonkeyPatch.context() as mp:
            it = iter([0.0, 1.0, 3.0, 3.5, 4.0, 10.0, 10.5])
            mp.setattr(mod.time, "perf_counter", lambda: next(it))
            timer = mod.StepTimer(window=2)
            dts = [timer.tick(), timer.tick()]
            with timer.stage("encode"):
                pass
            dts.append(timer.tick())
            timers.append((dts, timer.steps_per_sec, timer.stage_summary(),
                           timer.stage_summary()))
    assert timers[0] == timers[1]

    with tprof.trace(None):
        pass
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("stage"):
            torch.ones(4).sum()
    text = (tmp_path / "prof" / tprof.TRACE_FILE).read_text()
    assert '"traceEvents"' in text and '"stage"' in text
    # the profile needs a CUDA device: without one it raises, naming why
    with pytest.MonkeyPatch.context() as mp, pytest.raises(RuntimeError, match="CUDA"):
        mp.setattr(tprof.torch.cuda, "is_available", lambda: False)
        tprof.save_device_memory_profile(str(tmp_path / "mem.pickle"))
