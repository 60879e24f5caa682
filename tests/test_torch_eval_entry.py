"""The eval slice's entry points on the CPU: ``eval.validate.main`` (strict,
on a ``.pt``) over the five suites, ``tools.embed_videos`` against the JAX
package's tool, and ``train.common.load_pretrained_params`` on a ``.pt``,
on a directory of the port's checkpoints and on an orbax directory."""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from avion_tpu.data import video_reader as jvr
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.tools import embed_videos as jax_embed
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.eval import validate
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.tools import embed_videos
from avion_tpu_torch.train.common import load_pretrained_params

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TINY = dict(w=64, h=48, fps=10, chunk_s=2, clip_s=2, mir_clips=6,
            egtea_clips=4, charades_videos=4, charades_classes=5,
            mcq_items=4)
SUITES = ["ek100_mir", "ek100_cls", "egtea", "charades_ego", "egomcq"]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return chip_smoke.write_eval_fixtures(
        str(tmp_path_factory.mktemp("eval")), seed=0, **TINY)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A ``CLIP_TINY`` ``.pt`` in the reference layout, from JAX weights."""
    jm = jax_create_model("CLIP_TINY", num_frames=2)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    torch.save({"state_dict": params_from_jax(jax.device_get(params))}, path)
    return path


@pytest.fixture
def cv2_both(monkeypatch):
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", True)
    monkeypatch.setattr(pvr, "_native_lib", lambda: None)


def _validate_args(layout, ckpt):
    d = layout["data"]
    return ["model.name=CLIP_TINY", "model.project_embed_dim=32",
            "data.clip_length=2", "data.crop_size=32",
            "data.val_batch_size=4", "data.num_workers=0",
            f"data.chunk_len={d['chunk_len']}",
            f"data.val_metadata={d['val_metadata']}",
            f"data.relevancy_path={d['relevancy_path']}",
            f"data.root_val={d['root_val']}", f"pretrain_model={ckpt}"]


def test_validate_main_runs_the_five_suites(layout, ckpt, monkeypatch):
    for k, v in layout["env"].items():
        monkeypatch.setenv(k, v)
    res = validate.main(_validate_args(layout, ckpt) + ["--device", "cpu"])
    assert {k.split("_")[1] for k in res} == {"ek100", "egtea", "charades",
                                              "egomcq"}
    for suite in SUITES:
        assert any(k.startswith(f"test_{suite}_") for k in res), suite
    assert not any(k.endswith("_error") for k in res)
    assert all(np.isfinite(v) for v in res.values()), res


def test_validate_main_is_strict(layout, ckpt, monkeypatch, tmp_path):
    """A failing suite raises instead of giving an error sentinel."""
    meta = tmp_path / "egtea_meta"
    meta.mkdir()  # configured, but holds no split file
    monkeypatch.setenv("EGTEA_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("EGTEA_META_DIR", str(meta))
    args = ["model.name=CLIP_TINY", "model.project_embed_dim=32",
            "data.clip_length=2", "data.num_workers=0",
            f"pretrain_model={ckpt}", "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        validate.main(args)


def test_validate_main_needs_a_checkpoint_and_cuda(ckpt):
    with pytest.raises(SystemExit, match="pretrain_model"):
        validate.main(["model.name=CLIP_TINY", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="--device cpu"):
        validate.main(["model.name=CLIP_TINY", f"pretrain_model={ckpt}"])


def test_embed_videos_matches_the_jax_tool(ckpt, tmp_path, cv2_both):
    videos = tmp_path / "videos"
    videos.mkdir()
    for k in range(2):
        chip_smoke._write_chunk(str(videos / f"clip{k}.mp4"),
                                chip_smoke._canvas(
                                    np.random.RandomState(k), 64, 48),
                                0, frames=20, fps=10)
    texts = tmp_path / "texts.txt"
    texts.write_text("#C C opens the drawer\n\n#C C cuts the onion\n")
    common = ["--ckpt", ckpt, "--model", "CLIP_TINY", "--videos",
              str(videos), "--texts", str(texts), "--clip-length", "2",
              "--crop-size", "32", "--batch", "4"]
    jax_embed.main(common + ["--out", str(tmp_path / "jax.npz")])
    got = embed_videos.main(common + ["--out", str(tmp_path / "port.npz"),
                                      "--device", "cpu"])
    want = np.load(tmp_path / "jax.npz")
    saved = np.load(tmp_path / "port.npz")
    assert set(got) == set(saved.files) == set(want.files) == {
        "video_embeds", "video_names", "text_embeds", "texts"}
    assert got["video_embeds"].shape == (2, 32)
    assert got["text_embeds"].shape == (2, 32)
    for k in ("video_names", "texts"):
        np.testing.assert_array_equal(saved[k], want[k])
    for k in ("video_embeds", "text_embeds"):
        np.testing.assert_array_equal(saved[k], got[k])
        np.testing.assert_allclose(saved[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)


def test_load_pretrained_params_sources(ckpt, tmp_path):
    ref = create_model("CLIP_TINY", num_frames=2)
    load_pretrained_params(ckpt, ref, num_frames=2, strict=True)

    # a run's checkpoint directory: the newest step's model
    trained = create_model("CLIP_TINY", num_frames=2)
    trained.load_state_dict(ref.state_dict())
    with torch.no_grad():
        trained.logit_scale.add_(1.0)
    ckpts = Checkpointer(str(tmp_path / "run" / "ckpt"))
    for step, model in ((1, ref), (3, trained)):
        ckpts.save(step, TrainState(step, model, _NoOptimizer()))
    for path in (tmp_path / "run", tmp_path / "run" / "ckpt"):
        got = create_model("CLIP_TINY", num_frames=2)
        load_pretrained_params(str(path), got, strict=True)
        for k, v in trained.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k

    orbax = tmp_path / "orbax"
    (orbax / "12" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="export_clip_to_pt"):
        load_pretrained_params(str(orbax), create_model("CLIP_TINY"))
    with pytest.raises(FileNotFoundError):
        load_pretrained_params(str(tmp_path / "none"),
                               create_model("CLIP_TINY"))


class _NoOptimizer:
    def state_dict(self):
        return {}
