"""The port stands alone: ctpa_torch (its cli, comms and parallel too), chip_smoke.py,
bench_torch.py and the profile scripts import neither JAX, flax, pandas nor
anything of ctpa (nor, when a module loads, sklearn, safetensors,
transformers or matplotlib, which the card's machine lacks), build no
kernel through PyTorch's C++ extension machinery, and call no library
attention or quantized matmul."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys

# the card's machine has none of these; sklearn, safetensors, transformers
# and matplotlib may only be imported inside functions
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "pandas", "ctpa", "sklearn",
           "safetensors", "transformers", "matplotlib"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import ctpa_torch
names = ["ctpa_torch"] + [m.name for m in pkgutil.walk_packages(ctpa_torch.__path__, "ctpa_torch.")]
report = ["ctpa_torch.ops.decode_attention", "ctpa_torch.ops.rotary", "ctpa_torch.ops.sampling",
          "ctpa_torch.models.lora", "ctpa_torch.models.llm", "ctpa_torch.models.report_generator",
          "ctpa_torch.ops.flash_attention", "ctpa_torch.train.report_trainer",
          "ctpa_torch.train.train_state", "ctpa_torch.core.checkpoint", "ctpa_torch.ops.quant",
          "ctpa_torch.cli", "ctpa_torch.cli.export_serving", "ctpa_torch.ops.resample_patchify",
          "ctpa_torch.pipelines.streaming", "ctpa_torch.data.ingest", "ctpa_torch.data.nifti",
          "ctpa_torch.data.dicom", "ctpa_torch.data.hf_import", "ctpa_torch.models.pretrained",
          "ctpa_torch.data.tokenizer", "ctpa_torch.data.reports", "ctpa_torch.data.manifests",
          "ctpa_torch.data.datasets", "ctpa_torch.eval.classification",
          "ctpa_torch.eval.artifacts", "ctpa_torch.cli.zeroshot_infer",
          "ctpa_torch.cli.preprocess", "ctpa_torch.cli.train_report",
          "ctpa_torch.cli.generate_report", "ctpa_torch.cli.evaluate", "ctpa_torch.eval.nlg",
          "ctpa_torch.models.vqa_bert", "ctpa_torch.models.bert", "ctpa_torch.cli.train_clip",
          "ctpa_torch.data.prefetch", "ctpa_torch.core.logging", "ctpa_torch.core.profiling",
          "ctpa_torch.models.mlm", "ctpa_torch.models.visual_ssl", "ctpa_torch.models.ctclip",
          "ctpa_torch.models.ctvit", "ctpa_torch.train.clip_trainer",
          "ctpa_torch.cli.train_vqgan", "ctpa_torch.models.discriminator",
          "ctpa_torch.models.fallback_transformers", "ctpa_torch.models.attention",
          "ctpa_torch.ops.attention_ops", "ctpa_torch.ops.vq", "ctpa_torch.train.gan_losses",
          "ctpa_torch.train.vqgan_trainer", "ctpa_torch.core.mesh", "ctpa_torch.comms",
          "ctpa_torch.comms.collectives", "ctpa_torch.parallel", "ctpa_torch.parallel.context",
          "ctpa_torch.parallel.sharding"]
missing = sorted(set(report) - set(names))
assert not missing, missing
for name in names:
    importlib.import_module(name)
for script in ("chip_smoke", "bench_torch", "profile_zeroshot", "profile_clip_train",
               "profile_resample_patchify", "profile_int4_decode", "profile_int8_decode",
               "profile_quant_prefill", "profile_decode_attention", "profile_parallel"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
# HFTokenizer imports transformers only when it is built
from ctpa_torch.data.tokenizer import HFTokenizer
try:
    HFTokenizer("/nonexistent/snapshot")
except ImportError as e:
    assert "transformers" in str(e), e
else:
    raise AssertionError("HFTokenizer built without transformers")
print("imported", len(names), "modules")
"""


def test_port_imports_without_jax_or_ctpa():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


def test_port_sources_avoid_torch_extensions_and_library_attention():
    py = list((ROOT / "ctpa_torch").rglob("*.py")) + [ROOT / "bench_torch.py"]
    cu = list((ROOT / "ctpa_torch" / "csrc").glob("*.cu"))
    assert sorted(p.name for p in cu) == ["decode_attention.cu", "flash_attention.cu",
                                          "flash_attention_bwd.cu", "int4_ffn.cu", "int4_matmul.cu", "int8_ffn.cu",
                                          "int8_matmul.cu", "patchify.cu",
                                          "resample_patchify.cu"]
    headers = list((ROOT / "ctpa_torch" / "csrc").glob("*.cuh"))
    assert sorted(p.name for p in headers) == ["flash_masks.cuh", "flash_tiles.cuh",
                                               "hopper_ptx.cuh", "patch_wgmma.cuh",
                                               "prefill_wgmma.cuh", "stream_common.cuh",
                                               "warp_mma.cuh"]
    banned_py = ("import torch.utils.cpp_extension", "from torch.utils.cpp_extension",
                 "cpp_extension.load", "torch.compile(", "scaled_dot_product_attention(",
                 "_weight_int4pack_mm(", "_weight_int8pack_mm(", "_int_mm(")
    for path in py:
        text = path.read_text()
        assert not [b for b in banned_py if b in text], path
    for path in cu + headers:
        assert "#include <torch/" not in path.read_text(), path
