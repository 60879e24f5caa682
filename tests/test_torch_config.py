"""The port's copy of the config system against ``avion_tpu.core.config``:
the same ``section.key=value`` argv gives the same ``to_dict()``."""

import os

import pytest

from avion_tpu.core.config import TrainConfig as JaxTrainConfig
from avion_tpu.core.config import load_dotenv as jax_load_dotenv
from avion_tpu_torch.core.config import TrainConfig, load_dotenv

ARGVS = [
    [],
    ["model.name=CLIP_VITB16", "data.clip_length=4",
     "data.val_batch_size=32", "pretrain_model=x.pt"],
    ["model.use_quick_gelu=false", "optim.betas=(0.9,0.98)",
     "data.subsample_stride=none", "cutmix_minmax=0.2,0.8", "seed=3"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_overrides_match(argv):
    assert (TrainConfig().apply_overrides(argv).to_dict()
            == JaxTrainConfig().apply_overrides(argv).to_dict())


def test_unknown_key_raises():
    with pytest.raises(ValueError):
        TrainConfig().apply_overrides(["model.nope=1"])


def test_load_dotenv_matches(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("# c\nAVION_T_A='1'\nAVION_T_B = two\nbad line\n")
    monkeypatch.delenv("AVION_T_A", raising=False)
    monkeypatch.delenv("AVION_T_B", raising=False)
    assert load_dotenv(str(env)) == jax_load_dotenv(str(env))
    assert os.environ["AVION_T_B"] == "two"
