"""Shared helpers for the tests of the PyTorch port (``tossctr_tpu_torch``):
one tiny config both packages load, seeded numpy batches and kernel
inputs, the flax model with its kernels on (interpret mode on CPU) whose
parameters the port converts, and ``Checks``.

Each ``test_torch_*.py`` file holds ONE test item that runs its checks
through ``Checks``.  pytest-xdist's loadfile scheduling hands out the
files with the most items first, so one-item files run after the JAX
package's files: the suite's long poles start when they always did, and
``test_covis_rss.py`` (whose subprocess measurement inherits its
worker's peak RSS) meets the workers it always met.  For the same reason
the port and torch are imported inside the tests, not at collection.
Importing this module imports neither JAX nor torch, so the card-only
tests can use it on a machine without JAX."""

from __future__ import annotations

import contextlib
import copy
import traceback

import numpy as np

NUM_DIM = 5


class Checks:
    """Runs named checks inside one test item and reports every failed
    assertion together, so one item still says which cases broke."""

    def __init__(self):
        self.failed = []
        self.ran = 0

    def run(self, name: str, fn, *args, **kwargs):
        self.ran += 1
        try:
            fn(*args, **kwargs)
        except AssertionError:
            self.failed.append(f"--- {name}\n{traceback.format_exc(limit=3)}")

    def done(self):
        assert self.ran, "no checks ran"
        assert not self.failed, (
            f"{len(self.failed)} of {self.ran} checks failed:\n" + "\n".join(self.failed)
        )


@contextlib.contextmanager
def torch_threads(n: int = 1):
    """Keep torch's CPU ops on ``n`` threads: the suite runs in parallel
    workers that share the machine's cores."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def tiny_cfg_dict(amp: str = "none", **over) -> dict:
    d = {
        "exp_name": "tiny",
        "amp": amp,
        "data": {
            "cat_cols": ["gender", "inventory_id", "l_feat_1", "l_feat_2"],
            "hash_buckets": {"gender": 10, "inventory_id": 50, "l_feat_1": 20, "l_feat_2": 30},
        },
        "sequence": {
            "max_len": 24,
            "top_k": 6,  # padded to K=8 by pad_topk: exercises the valid_k mask
            "recency_tau": 8,
            "query_mode": "concat",
            "query_key": "inventory_id",
            "transformer_block": True,
            "tfm": {"n_layers": 2, "n_heads": 2, "ffn_hidden": 32},
        },
        "model": {
            "emb_dim": 16,
            "seq_vocab": 300,
            "table_dtype": "bfloat16" if amp == "bf16" else "float32",
            "use_pallas_attention": True,
            "use_pallas_ffn": True,
            "cat_embedding_dims": {"gender": 4, "inventory_id": 8, "l_feat_1": 4},
            "qnn_alpha": {
                "enabled": True,
                "feature_embed_dim": 8,
                "heads": 2,
                "rank": 4,
                "proj_dim": 12,
                "mlp_hidden": [32, 16],
                "pair_grouping": "all",
            },
        },
        "train": {"batch_size": 8, "epochs": 1},
        "calibration": {"enabled": True, "method": "temperature"},
        "ensemble": {"method": "logit_mean"},
    }

    def deep_update(a, u):
        for k, v in u.items():
            if isinstance(v, dict) and isinstance(a.get(k), dict):
                deep_update(a[k], v)
            else:
                a[k] = v

    deep_update(d, copy.deepcopy(over))
    return d


# five categorical columns: 1 + NUM_DIM + NUM_DIM + 5 = 16 QNN tokens, a
# multiple of 8, so ``model.extra.use_pallas_fm`` takes the FM-cross kernels
FM_CATS = {"cat_cols": ["gender", "inventory_id", "l_feat_1", "l_feat_2", "l_feat_3"],
           "hash_buckets": {"gender": 10, "inventory_id": 50, "l_feat_1": 20, "l_feat_2": 30,
                            "l_feat_3": 15}}


def dims_for(d: dict) -> dict:
    return {"X_num": NUM_DIM, "X_mask": NUM_DIM, "X_cat": len(d["data"]["cat_cols"]),
            "seq_len": d["sequence"]["max_len"]}


def make_batch(d: dict, B: int = 8, seed: int = 0) -> dict:
    """Seeded numpy batch; a few all-pad and short sequences."""
    rng = np.random.default_rng(seed)
    L = d["sequence"]["max_len"]
    seq = rng.integers(1, d["model"]["seq_vocab"], (B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, B)
    lens[0] = 0
    seq[np.arange(L)[None, :] < (L - lens)[:, None]] = 0
    hb = d["data"]["hash_buckets"]
    return {
        "X_num": rng.normal(0, 1, (B, NUM_DIM)).astype(np.float32),
        "X_mask": (rng.random((B, NUM_DIM)) < 0.2).astype(np.float32),
        "X_cat": np.stack([rng.integers(0, hb[c], B) for c in d["data"]["cat_cols"]], 1)
        .astype(np.int32),
        "seq": seq,
    }


# initialised variables by config without its kernel switches, for the
# test process: the kernels and their plain paths hold the same
# parameters (same names, shapes and initialisers), so a config that
# differs from one already initialised only in those switches reuses its
# variables (the same values a fresh init would give) instead of paying
# the init's compile again
_KERNEL_SWITCHES = ("use_pallas_attention", "use_pallas_ffn")
_INIT_CACHE: dict = {}
# XLA's CPU compiler options for the JAX programs the tests only run once
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def compiled(jitted, *args):
    """``jitted`` (a ``jax.jit`` function) compiled for ``args`` with
    ``FAST_COMPILE``: no LLVM optimisation, which halves the compile of a
    small program run once or twice.  The same XLA program; LLVM's
    optimisations could only move a rounding (a fused multiply-add)."""
    return jitted.lower(*args).compile(compiler_options=FAST_COMPILE)


def jax_model_and_variables(d: dict, batch: dict, seed: int = 0):
    """The flax CTRModel the JAX package builds for ``d`` (fused-block
    kernels on) and its initialised variables.  The parameters do not
    depend on the kernel switches: they are initialised once a config with
    the switches off, on XLA's attention and FFN (whose init compiles
    several times faster than interpret-mode Pallas), checked to fit
    ``d``'s model leaf for leaf, and returned as host arrays."""
    import json

    import jax

    from tossctr_tpu.config import Config
    from tossctr_tpu.train.trainer import build_model

    model = build_model(Config.from_dict(copy.deepcopy(d)), dims_for(d))
    plain_d = copy.deepcopy(d)
    plain_d["model"].update({k: False for k in _KERNEL_SWITCHES})
    key = (json.dumps(plain_d, sort_keys=True), seed,
           tuple((k, np.shape(v), str(np.asarray(v).dtype)) for k, v in sorted(batch.items())))
    if key not in _INIT_CACHE:
        plain = build_model(Config.from_dict(plain_d), dims_for(d))
        # the program of ``jitted_init`` (tossctr_tpu/train/trainer.py),
        # which the JAX package uses for its parameters: keep the two
        # alike.  Compiled without LLVM's optimisations: it only draws the
        # parameters, and compiles in half the time
        init = jax.jit(lambda k, b: plain.init(k, b, deterministic=True))
        args = (jax.random.PRNGKey(seed), batch)
        _INIT_CACHE[key] = {"params": compiled(init, *args)(*args)["params"]}
    variables = _INIT_CACHE[key]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(seed), batch,
                                               deterministic=True))
    assert (jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), {"params": shapes["params"]})
            == jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), variables)), \
        "the variables do not fit the model"
    # a copy: a JAX train step donates its state's buffers
    return model, jax.tree_util.tree_map(np.array, variables)


def jitted_vjp(fn, args, cotangent):
    """-> (fn(*args), the gradients of ``cotangent`` through it), both from
    one jitted program: run eagerly, ``jax.vjp`` of an interpret-mode
    Pallas kernel compiles each of its primitives apart, which costs
    several times the compile of the whole."""
    import jax

    def both(cot, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(cot)

    return jax.jit(both)(cotangent, *args)


def port_model(d: dict, variables, device: str = "cpu"):
    """The port's CTRModel for ``d`` holding the converted flax params."""
    import jax

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict
    from tossctr_tpu_torch.models import build_model

    cfg = Config.from_dict(copy.deepcopy(d))
    model = build_model(cfg, dims_for(d), device=device)
    model.load_state_dict(flax_to_state_dict(jax.device_get(variables)), strict=True)
    return model


def torch_batch(batch: dict):
    import torch

    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# x, o, wout, w1, w2 of fused_block_tail are in the compute dtype; the
# biases and norm weights stay fp32
LOWP_TAIL = (0, 1, 2, 5, 7)


def bf16_band(ref: np.ndarray) -> float:
    """3 bf16 ulps of the largest output magnitude."""
    top = float(np.abs(ref).max())
    return 3.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


def attn_inputs(seed, B=6, K=12, D=16, masked_cols=3):
    """x, wqkv, bqkv, bias for fused_mha_qkv; the last ``masked_cols``
    key columns carry -1e9, as the valid_k mask of pad_topk does."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, K, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(0, 0.1, 3 * D).astype(np.float32)
    bias = rng.normal(0, 1, (K, K)).astype(np.float32)
    if masked_cols:
        bias[:, K - masked_cols:] = -1e9
    return x, w, b, bias


def tail_inputs(seed, N=40, D=16, F=48):
    """The ten inputs of fused_block_tail, all fp32."""
    rng = np.random.default_rng(seed)

    def r(*s, sd=1.0):
        return rng.normal(0, sd, s).astype(np.float32)

    return [r(N, D), r(N, D), r(D, D, sd=D ** -0.5), r(D, sd=0.1), 1 + r(D, sd=0.1),
            r(D, F, sd=D ** -0.5), r(F, sd=0.1), r(F, D, sd=F ** -0.5), r(D, sd=0.1),
            1 + r(D, sd=0.1)]
