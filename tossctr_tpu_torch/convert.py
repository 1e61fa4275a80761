"""Flax parameter tree -> this package's ``state_dict``.

The port's modules keep the flax scope and parameter names, so a flax
variables tree maps onto ``state_dict`` keys path for path, with ``.``
for ``/``:

    dare/emb_tables                     -> dare.emb_tables
    dare/layer_0/mha/qkv/kernel         -> dare.layer_0.mha.qkv.kernel
    cat_embed/table_8, cat_embed/proj_8 -> cat_embed.table_8, cat_embed.proj_8
    qnn/RMSNorm_0/w, qnn/se/Dense_0/... -> qnn.RMSNorm_0.w, qnn.se.Dense_0...

Layouts are kept too: a flax ``Dense.kernel`` is (in, out) and the port's
``Dense`` multiplies by it as stored.  A bfloat16 leaf (an ``ml_dtypes``
array, or the msgpack reader's tensor) becomes ``torch.bfloat16``.

``load_flax_train_state`` carries a whole JAX sparse-table ``TrainState``
across (parameters, AdamW moments, EMA shadow, step and the table's
AdaGrad accumulator), so a test can start both packages' train steps
from one state.  Imports neither flax, optax nor the JAX package: leaves
are numpy arrays or torch tensors, and the optimizer and EMA states are
read by their field names.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# encoder-layer norms were once auto-named RMSNorm_0/1; inside a scope
# that holds an "mha" sibling they are norm1/norm2 (QNN's pre-norm keeps
# its auto name) -- tossctr_tpu/train/checkpoint.py _migrate_norm_names
_NORM_RENAMES = {
    "RMSNorm_0": "norm1", "RMSNorm_1": "norm2",
    "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
}


def migrate_norm_names(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    is_layer = "mha" in tree
    return {
        (_NORM_RENAMES.get(k, k) if is_layer else k): migrate_norm_names(v)
        for k, v in tree.items()
    }


def to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax variables tree ({"params": {...}} or the params dict itself)
    -> {dotted flax path: tensor}."""
    tree = variables.get("params", variables) if isinstance(variables, dict) else variables
    tree = migrate_norm_names(tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                out[key] = to_tensor(v)

    walk("", tree)
    return out


@torch.no_grad()
def load_flax_train_state(state, jax_state) -> None:
    """Copy a JAX ``TrainState`` (sparse-table mode, leaves fetched to the
    host) into the port's ``train.trainer.TrainState`` in place."""
    model = state.model
    model.load_state_dict(flax_to_state_dict(jax_state.params), strict=True)
    params = dict(model.named_parameters())
    adam = next(s for s in jax_state.opt_state if hasattr(s, "mu"))
    mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
    for p in (q for group in state.opt.param_groups for q in group["params"]):
        name = next(n for n, q in params.items() if q is p)
        state.opt.state[p] = {
            "step": torch.tensor(float(np.asarray(adam.count))),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }
    if state.ema is not None:
        shadow = flax_to_state_dict(jax_state.ema.shadow)
        for n, s in state.ema.shadow.items():
            s.copy_(shadow[n])
        state.ema.num_updates = int(np.asarray(jax_state.ema.num_updates))
    state.step = int(np.asarray(jax_state.step))
    for n, t in state.table_opt.items():
        t.accum.copy_(to_tensor(jax_state.table_opt[n].accum))
