"""``launch/train.main`` over a process group, on the CPU.

* An LM on a 2-rank ``gloo`` world (granite-moe-3b-a800m SMOKE): its
  state distributed by the config's rules over ``make_host_mesh()``,
  each rank feeding its rows of every batch, a checkpoint gathered and
  written by rank 0 and ``--resume`` restoring it with ``shardings=``;
  each rank prints the one-process launcher's losses.
* SASRec (its item table split by the ``"items"`` rule) and a GNN
  (SchNet: params replicated, the graph's nodes and edges split) on 2
  ranks print the one-process launcher's losses (SchNet's first: its bf16
  sums add in another order on two ranks, so later steps drift).

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


def _one_process(arch):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(["--arch", arch, "--device", "cpu", "--steps", "3"]) == 0
    return re.findall(r"step\s+(\d+) loss ([-\d.]+)", buf.getvalue())


def test_launcher_refuses_a_gnn_on_two_ranks(tmp_path):
    """Kept under its old name (the launcher refused a GNN at world 2
    before its sharded step was ported): SchNet trains on 2 ranks, each
    printing the one-process run's first loss."""
    ranks = spawn_world(_gnn_rank, 2, ("schnet",), timeout_s=WORLD_TIMEOUT_S,
                        store_dir=str(tmp_path / "store"))
    one = _one_process("schnet")
    for text in ranks:
        losses = re.findall(r"step\s+(\d+) loss ([-\d.]+)", text)
        assert [s for s, _ in losses] == ["0", "2"] and "done" in text
        assert losses[0] == one[0]
    assert [re.findall(r"loss ([-\d.]+)", t) for t in ranks[:1]] == \
        [re.findall(r"loss ([-\d.]+)", t) for t in ranks[1:]]


def test_launcher_trains_sasrec_on_two_gloo_ranks(tmp_path):
    ranks = spawn_world(_gnn_rank, 2, ("sasrec",), timeout_s=WORLD_TIMEOUT_S,
                        store_dir=str(tmp_path / "store"))
    one = _one_process("sasrec")
    for text in ranks:
        assert re.findall(r"step\s+(\d+) loss ([-\d.]+)", text) == one


def _gnn_rank(rank, world, arch):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(["--arch", arch, "--device", "cpu", "--steps", "3"]) == 0
    return buf.getvalue()
