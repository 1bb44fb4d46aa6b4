"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, in a fresh interpreter and in the source
text alike."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).replace(".__init__", "")
    for p in PORT.rglob("*.py")
)

FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.MULTILINE)


def test_slice_modules_are_all_listed():
    for name in (
        "repro_torch.core.semiring", "repro_torch.core.condensed",
        "repro_torch.core.relational", "repro_torch.core.dsl",
        "repro_torch.core.planner", "repro_torch.core.extract",
        "repro_torch.data.synth", "repro_torch.core.dedup",
        "repro_torch.kernels.pack", "repro_torch.kernels.correction",
        "repro_torch.kernels.bitmap_spmm", "repro_torch.kernels.ref",
        "repro_torch.core.engine", "repro_torch.core.algorithms",
        "repro_torch.serve.server", "repro_torch.core.interop",
        "repro_torch.configs.base", "repro_torch.configs.glm4_9b",
        "repro_torch.configs.yi_9b", "repro_torch.configs.registry",
        "repro_torch.kernels.flash_attention", "repro_torch.models.layers",
        "repro_torch.models.transformer", "repro_torch.models.interop",
        "repro_torch.launch.serve", "repro_torch.kernels.ops",
        "repro_torch.kernels.autotune", "repro_torch.core.serialize",
        "repro_torch.data.pipeline", "repro_torch.core.delta",
        "repro_torch.core.cost", "repro_torch.core.advisor",
        "repro_torch.serve.tier", "repro_torch.launch.cells",
        "repro_torch.launch.report", "repro_torch.distributed",
        "repro_torch.distributed.world", "repro_torch.distributed.sharding",
        "repro_torch.distributed.compression", "repro_torch.core.banding",
        "repro_torch.launch.mesh", "repro_torch.launch.orchestrator",
        "repro_torch.launch.distributed_analytics", "repro_torch.train",
        "repro_torch.train.checkpoint", "repro_torch.configs.graphgen_paper",
        "repro_torch.train.optimizer", "repro_torch.train.steps",
        "repro_torch.models.sasrec", "repro_torch.models.gnn",
        "repro_torch.data.graphs", "repro_torch.configs.sasrec",
        "repro_torch.configs.meshgraphnet", "repro_torch.configs.graphcast",
        "repro_torch.configs.schnet", "repro_torch.configs.dimenet",
        "repro_torch.configs.shapes", "repro_torch.launch.train",
        "repro_torch.launch.recsys_serve", "repro_torch.models.moe",
        "repro_torch.configs.granite_moe_3b_a800m",
        "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.configs.llama3_405b",
        "repro_torch.launch.dryrun", "repro_torch.launch.op_cost",
        "repro_torch.launch.roofline", "repro_torch.launch.train_lm",
    ):
        assert name in MODULES


def test_fresh_interpreter_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')"
        " or m.startswith(('jax.', 'repro.'))]\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_neither_jax_nor_reference(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path
