"""The port's twin of ``examples/elastic_rescale.py`` on the CPU:
``examples/torch_elastic_rescale.py``'s ``main(device="cpu")`` spawns its 8
gloo ranks once, in a module fixture. Each rank trains reduced
llama4-scout 5 steps on (2,4), restores them on (4,2) with the same
``params_digest()`` (the original's assertion) and trains to 10, then
restores step 10 on (8,1) and trains to 12; every rank reports the same.
The JAX package's one-device Trainer restores the twin's newest
checkpoint (step 12, written by 8 ranks) with the same ``restored_from``
and ``params_digest()``. ~29 s alone at ``-n 6 --dist loadfile``."""
import pytest

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import reduced as jreduced
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from test_torch_examples import run_twin


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    return run_twin("elastic_rescale", tmp_path_factory.mktemp("elastic"))


def test_every_rank_rescales_exactly(elastic):
    ranks = elastic["ranks"]
    assert [r["rank"] for r in ranks] == list(range(8))
    for r in ranks:
        assert r["restored_digest_5"] == r["digest_5"]
        assert r["restored_from"] == [5, 10]
        assert r["reports"] == [["completed", 5], ["completed", 10],
                                ["completed", 12]]
        assert r["digest_12"] != r["digest_5"]
        assert r["peak_device_bytes"] is None
    check = elastic["check"]
    assert check["ok"] and check["digests_equal_across_meshes"]
    assert check["ranks"] == 8 and check["restored_from"] == [5, 10]
    assert check["reports"] == [["completed", 5], ["completed", 10],
                                ["completed", 12]]


def test_jax_trainer_restores_the_twins_newest_checkpoint(elastic):
    t = JTrainer(jreduced(JCONFIGS["llama4-scout-17b-a16e"]),
                 JTrainerConfig(workdir=elastic["workdir"], batch=8,
                                seq_len=64, ckpt_every=5, seed=0,
                                log_every=5))
    t.init_or_restore()
    assert t.restored_from == 12
    assert t.params_digest() == elastic["ranks"][0]["digest_12"]
    t.manager.close()
