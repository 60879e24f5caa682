"""The port imports nothing of JAX or of the JAX package, and no
``pandas``, ``regex``, ``transformers``, ``matplotlib`` or ``wandb`` (the
card's machine has none of them; the port's imports of them are inside the
functions that need them): every module of
``avion_tpu_torch`` and ``chip_smoke.py`` import in a fresh interpreter
where those names are blocked."""

import os
import pkgutil
import subprocess
import sys

import avion_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "avion_tpu", "pandas",
           "regex", "transformers", "matplotlib", "wandb")

_SCRIPT = r"""
import importlib, sys
blocked = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("blocked: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in blocked:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
for mod in {modules!r}:
    importlib.import_module(mod)
sys.path.insert(0, {root!r})
importlib.import_module("chip_smoke")
print("imported", len({modules!r}))
"""


def _modules():
    out = ["avion_tpu_torch"]
    for info in pkgutil.walk_packages(avion_tpu_torch.__path__,
                                      "avion_tpu_torch."):
        out.append(info.name)
    return out


def test_port_imports_nothing_of_jax():
    modules = _modules()
    assert "avion_tpu_torch.serve.server" in modules
    assert "avion_tpu_torch.ops.flash_attention" in modules
    for mod in ("train.pretrain_clip", "train.loop", "train.steps",
                "optim.factory", "optim.schedules", "losses.losses",
                "core.checkpoint", "core.train_state", "core.meters",
                "core.logging", "data.loader", "parallel.launch",
                "data.video_reader", "data.metadata", "data.sampling",
                "data.datasets", "data.shards", "ops.fused_input",
                "eval.validate", "eval.retrieval_metrics",
                "eval.classification_metrics", "train.common",
                "train.finetune_cls", "tools.embed_videos",
                "models.videomae", "data.rand_augment",
                "train.augment_device", "train.videomae_pretrain",
                "train.videomae_finetune", "train.finetune_mir",
                "models.clip", "models.vit", "ops.attention",
                "models.narrator", "models.timesformer",
                "models.gpt2_gated", "models.lavila", "models.lavila_import",
                "train.train_narrator", "tools.narrator",
                "data.roberta_tokenizer", "egonlq", "egonlq.nlq_eval",
                "egonlq.nlq_dataset", "egonlq.vslnet", "egonlq.train_nlq",
                "egonlq.features", "egonlq.extract_features",
                "egonlq.egovlp", "core.flops", "core.profiling",
                "tools.profile_step", "tools.convert_checkpoint",
                "tools.chunk_videos", "tools.bench_decode",
                "tools.alignment_ablation", "tools.refinement_eval",
                "tools.dataset_tools", "tools.narration_refinement",
                "tools.metrics_extractor", "tools.plots",
                "tools.e2e_convergence", "ops.moe", "parallel.pipeline",
                "parallel.pipeline_gated"):
        assert f"avion_tpu_torch.{mod}" in modules
    script = _SCRIPT.format(blocked=BLOCKED, modules=modules, root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(modules)}" in res.stdout
