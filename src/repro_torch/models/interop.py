"""Carry the JAX package's transformer weights into the port.

The tests flatten the reference's params pytree to numpy arrays keyed by
path (``"embed"``, ``"layers/attn/wq"`` stacked ``(L, D, H*hd)``,
``"layers/mlp/w_gate"``, ``"layers/ln1"``, ``"final_norm"``,
``"lm_head"``) and hand them here, so that both packages run the same
weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import TransformerConfig
from .transformer import torch_dtype

__all__ = ["transformer_params_from_arrays"]


def transformer_params_from_arrays(
    arrays: Mapping[str, np.ndarray], cfg: TransformerConfig, device="cuda"
) -> Dict:
    """The port's param dict from path-keyed arrays, every weight cast to
    ``cfg.dtype`` once (the reference casts at each use: same numbers)."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN is not ported yet")
    dt = torch_dtype(cfg.dtype)
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
        a = np.array(arrays[path], dtype=np.float32, order="C")
        return torch.from_numpy(a).to(device=device, dtype=dt)

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
