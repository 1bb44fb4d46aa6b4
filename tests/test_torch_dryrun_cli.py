"""The dry-run's cells against the reference, its CLI and its report, on
the CPU.

* The banded graphgen cell over a fake group of 512 ranks in this process
  (destroyed after the module): its collective bytes per PageRank
  iteration equal the reference's ``collective_bytes`` on its compiled
  512-device HLO (one all-gather, one psum-scatter and the dangling
  mass's all-reduce in both).
* The CLI as a subprocess: graphgen-paper at ``--mesh multi`` (512 ranks,
  collective time > 0) and glm4-9b's SMOKE train cell at ``multi``, both
  with ``--device cpu``; without a card and without ``--device cpu`` the
  CLI refuses.
* ``launch/report.py`` renders saved records.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist

    from repro_torch.distributed.world import init_fake_group, initialized

    assert not initialized()
    init_fake_group(512)
    yield
    dist.destroy_process_group()


JAX_BANDED = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.distributed.sharding import use_mesh_rules
from repro.launch import cells
from repro.launch.mesh import make_production_mesh
from repro.launch.roofline import collective_bytes
mesh = make_production_mesh(multi_pod=True)
cell = cells.build_cell("graphgen-paper", "pagerank", mesh, variant="banded")
with use_mesh_rules(mesh, cell.rules):
    comp = jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(*cell.args).compile()
print(json.dumps(collective_bytes(comp.as_text())))
"""


def test_banded_cell_collective_bytes_per_iteration_equal_the_references(fake_world):
    """The reference's HLO holds the PageRank loop body once, so its
    ``collective_bytes`` are one iteration's: one all-gather, one
    psum-scatter and the dangling mass's all-reduce.  The port's per
    iteration is the difference of its traces at 2 and 1 iterations (the
    result's final all-gather is outside the loop)."""
    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import measure_cell
    from repro_torch.launch.mesh import make_production_mesh

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_BANDED], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    c1, c2 = (measure_cell(cells.build_cell("graphgen-paper", "pagerank", mesh,
                                            variant="banded", depth=d), "cpu") for d in (1, 2))
    per_iter = {k: c2.by_collective.get(k, 0) - c1.by_collective.get(k, 0)
                for k in set(c2.by_collective) | set(c1.by_collective)}
    assert per_iter == want["by_op"]
    assert (c2.ici_bytes + c2.dci_bytes) - (c1.ici_bytes + c1.dci_bytes) == \
        want["ici_bytes"] + want["dci_bytes"]
    assert c2.n_collectives - c1.n_collectives == want["n_collectives"] == 3


# ---------------------------------------------------------------------------
# the CLI and the report
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--device", "cpu"],
                          capture_output=True, text=True, timeout=600, cwd=REPO, env=env)


@pytest.mark.parametrize("args,record", [
    (("--arch", "graphgen-paper", "--shape", "pagerank", "--mesh", "multi"),
     "graphgen-paper__pagerank__multi.json"),
    (("--arch", "glm4-9b", "--shape", "train_4k", "--mesh", "multi", "--smoke"),
     "glm4-9b__train_4k__multi__smoke.json"),
])
def test_dryrun_cli_subprocess(args, record):
    proc = _cli(*args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all dry-run cells OK" in proc.stdout
    with open(os.path.join(REPO, "results", "dryrun_torch", record)) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["n_chips"] == 512 and rec["mesh"] == "multi"
    assert rec["collective_s"] > 0               # the sharded step communicates
    assert rec["memory_stats"]["peak_bytes_per_device"] > 0
    if "glm4-9b" in record:
        assert rec["flops_per_device"] > 0 and rec["op_counts"]["repro_torch.flash_attention"] > 0
        assert rec["trace"]["smoke"] is True


def test_dryrun_cli_refuses_without_a_card(monkeypatch):
    """No silent fall back to the CPU: the CLI's ``--device`` defaults to
    the card, and without one it exits unless given ``--device cpu``."""
    import torch

    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device: pass --device cpu"):
        dryrun.main(["--arch", "glm4-9b", "--shape", "train_4k", "--mesh", "host"])


def test_report_renders_saved_records(tmp_path):
    from repro_torch.launch import report

    base = {"ok": True, "mesh": "single", "n_chips": 256, "flops_per_device": 1e12,
            "ici_bytes": 2.0 ** 20, "dci_bytes": 0.0, "nvlink_bytes": 0.0,
            "network_bytes": 2.0 ** 20, "lower_s": 3.0, "compile_s": 0.0, "compute_s": 0.001,
            "memory_s": 0.002, "collective_s": 0.003, "dominant": "collective",
            "model_flops": 2.5e14, "useful_ratio": 0.9765625,
            "memory_stats": {"peak_bytes_per_device": 3 * 2.0 ** 30}}
    recs = [dict(base, arch="glm4-9b", shape="train_4k"),
            dict(base, arch="sasrec", shape="serve_p99", mesh="multi", dominant="memory"),
            {"ok": False, "arch": "x", "shape": "y", "mesh": "single", "error": "boom"}]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    text = report.render("single", str(tmp_path))
    assert "cells passed: 2; failed: 1" in text and "FAILED xxyxsingle: boom" in text
    assert "| glm4-9b | train_4k | 256 | 3.0GB | 1.00e+12 | 1.0MB | 0.0B | 0.0B | 1.0MB | 3 |" \
        in text
    assert "| glm4-9b | train_4k | 0.0010 | 0.0020 | 0.0030 | **collective** | 2.50e+14 " \
           "| 0.977 |" in text
    assert "sasrec" not in text.split("## Dry-run")[1]
    assert report.main(["--mesh", "multi", "--results", str(tmp_path)]) == 0
