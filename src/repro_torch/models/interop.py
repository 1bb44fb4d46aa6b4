"""Carry the JAX package's weights and train states into the port.

The tests flatten the reference's pytrees to numpy arrays keyed by path
(``"embed"``, ``"layers/attn/wq"`` stacked ``(L, D, H*hd)``, ...; for a
train state ``"params/..."``, ``"opt/m/..."``, ``"step"``,
``"grad_err/..."``) and hand them here, so that both packages run the
same weights.  Each function checks the paths (and, for the model
families, the shapes) against the port's own layout, which is the
reference's path for path.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import GNNConfig, RecsysConfig, TransformerConfig
from .transformer import torch_dtype

__all__ = [
    "transformer_params_from_arrays",
    "sasrec_params_from_arrays",
    "gnn_params_from_arrays",
    "train_state_from_arrays",
    "tree_from_arrays",
]


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A tensor of ``a`` on ``device``; a NumPy ``bfloat16`` array (from
    ``ml_dtypes``) is read through an ``int16`` view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


def tree_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda", dtype=None) -> Dict:
    """Path-keyed arrays -> nested dict of tensors (their own dtypes, or
    ``dtype``)."""
    root: Dict = {}
    for path, a in arrays.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(a, device, dtype)
    return root


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _check_layout(arrays: Mapping[str, np.ndarray], template: Dict, what: str) -> None:
    want = {path: tuple(t.shape) for path, t in _paths(template)}
    if set(arrays) != set(want):
        raise ValueError(
            f"{what}: param paths differ: missing {sorted(set(want) - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - set(want))}")
    bad = {p: (tuple(np.shape(a)), want[p]) for p, a in arrays.items()
           if tuple(np.shape(a)) != want[p]}
    if bad:
        raise ValueError(f"{what}: shapes differ (got, want): {bad}")


def sasrec_params_from_arrays(
    arrays: Mapping[str, np.ndarray], cfg: RecsysConfig, device="cuda"
) -> Dict:
    """SASRec params in ``cfg.param_dtype``, checked against the port's
    layout at ``cfg``."""
    from . import sasrec

    _check_layout(arrays, sasrec.init_params(cfg, None, device="meta"), cfg.name)
    return tree_from_arrays(arrays, device, torch_dtype(cfg.param_dtype))


def gnn_params_from_arrays(
    arrays: Mapping[str, np.ndarray], cfg: GNNConfig, d_in: int, d_edge_in: int = 4,
    device="cuda",
) -> Dict:
    """GNN params in ``cfg.param_dtype``, checked against the port's layout
    for ``cfg`` at ``d_in`` input features."""
    from . import gnn

    template = gnn.init_params(cfg, None, d_in, d_edge_in, device="meta")
    _check_layout(arrays, template, cfg.name)
    return tree_from_arrays(arrays, device, torch_dtype(cfg.param_dtype))


def train_state_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda") -> Dict:
    """A train state (``params``, the optimizer's ``opt`` state: AdamW's
    ``m`` / ``v``, sgdm's ``mom`` or adafactor's ``f``; ``step``; and
    ``grad_err`` where gradients are compressed) from path-keyed arrays,
    each in its own dtype; ``step`` an int32 scalar."""
    top = {path.split("/")[0] for path in arrays}
    if not {"params", "opt", "step"} <= top or top - {"params", "opt", "step", "grad_err"}:
        raise ValueError(f"a train state has params, opt, step (and grad_err); got {sorted(top)}")
    state = tree_from_arrays(arrays, device)
    state["step"] = state["step"].to(torch.int32).reshape(())
    return state


def transformer_params_from_arrays(
    arrays: Mapping[str, np.ndarray], cfg: TransformerConfig, device="cuda",
    dtype=None,
) -> Dict:
    """The port's param dict from path-keyed arrays, every weight cast to
    ``dtype``: by default ``cfg.dtype`` once, for serving (the reference
    casts at each use: same numbers); training passes ``cfg.param_dtype``'s
    and the forward casts at use."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN is not ported yet")
    dt = dtype or torch_dtype(cfg.dtype)
    expected = {"embed", "final_norm", "layers/ln1", "layers/ln2"}
    expected |= {f"layers/attn/{n}" for n in ("wq", "wk", "wv", "wo")}
    expected |= {f"layers/mlp/{n}" for n in ("w_gate", "w_up", "w_down")}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if set(arrays) != expected:
        raise ValueError(
            f"param paths differ: missing {sorted(expected - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - expected)}"
        )

    def tensor(path: str) -> torch.Tensor:
        return _tensor(np.asarray(arrays[path], dtype=np.float32), device, dt)

    params: Dict = {
        "embed": tensor("embed"),
        "final_norm": tensor("final_norm"),
        "layers": {
            "ln1": tensor("layers/ln1"),
            "ln2": tensor("layers/ln2"),
            "attn": {n: tensor(f"layers/attn/{n}") for n in ("wq", "wk", "wv", "wo")},
            "mlp": {n: tensor(f"layers/mlp/{n}") for n in ("w_gate", "w_up", "w_down")},
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = tensor("lm_head")
    return params
