"""``launch/train.main`` over a process group, on the CPU.

* An LM on a 2-rank ``gloo`` world (granite-moe-3b-a800m SMOKE): its
  state distributed by the config's rules over ``make_host_mesh()``,
  each rank feeding its rows of every batch, a checkpoint gathered and
  written by rank 0 and ``--resume`` restoring it with ``shardings=``;
  each rank prints the one-process launcher's losses.
* SASRec and the GNNs train on one rank: at world 2 the launcher raises
  a ``ValueError`` that names ROADMAP.md Queue 1 item 2.

The sharded step itself is held against the JAX package's in
``tests/test_torch_sharded_train.py``.  Spawned ranks run functions of
this module.
"""
import contextlib
import io
import re

import pytest

from repro_torch.distributed.world import spawn_world

WORLD_TIMEOUT_S = 240


def _launcher_rank(rank, world, ckpt_dir):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = train.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--steps", "3",
                            "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "2"])
        again = train.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--steps", "5",
                            "--checkpoint-dir", ckpt_dir, "--resume"])
    return first, again, buf.getvalue()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    return spawn_world(_launcher_rank, 2, (str(tmp / "ckpt"),), timeout_s=WORLD_TIMEOUT_S,
                       store_dir=str(tmp / "store"))


def test_launcher_trains_an_lm_on_two_gloo_ranks(launched):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--steps", "3"]) == 0
    one = re.findall(r"step\s+(\d+) loss ([-\d.]+)", buf.getvalue())
    for first, again, text in launched:
        assert first == again == 0
        assert "resumed from step 3" in text and text.count("done") == 2
        losses = re.findall(r"step\s+(\d+) loss ([-\d.]+)", text)
        assert losses[:len(one)] == one          # 4-digit losses of the one-process run
        assert [s for s, _ in losses] == ["0", "2", "4"]
    ranks = [re.findall(r"step\s+(\d+) loss ([-\d.]+)", text) for _, _, text in launched]
    assert ranks[0] == ranks[1]


def test_launcher_refuses_a_gnn_on_two_ranks(tmp_path):
    with pytest.raises(Exception, match="Queue 1 item 2"):
        spawn_world(_gnn_rank, 2, (), timeout_s=WORLD_TIMEOUT_S,
                    store_dir=str(tmp_path / "store"))


def _gnn_rank(rank, world):
    from repro_torch.launch import train

    train.main(["--arch", "schnet", "--device", "cpu", "--steps", "1"])
