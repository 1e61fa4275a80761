"""The sparse-table train step and the eval step.

Port of ``tossctr_tpu/train/trainer.py`` as ``bench.py`` drives it:
``build_model``, ``make_optimizer``, ``make_train_state``,
``make_train_step`` (its sparse-table branch, ``exact_dedup: true``) and
``make_eval_step``.  The step is an eager PyTorch function on the card:

  1. forward with every dropout of the config (kernel dropout seeds from
     a CPU generator seeded from (train seed, step): ``fold_in``),
  2. WLL-style BCE + ``aux_head_weight`` x the aux head's,
  3. backward, through the encoder kernels' backward kernels,
  4. the gradient of the gathered table rows (``models/dare.py`` taps),
  5. global-norm clip over the dense and row gradients together,
  6. AdamW on the dense parameters, lr from the warmup + cosine schedule
     at the step the update starts from,
  7. row-wise AdaGrad with exact dedup on the sequence table,
  8. EMA of the dense parameters (the table has no shadow).

The model's parameters are the state's parameters: the step updates
them in place.  The dense-mode step, the fold loop (``train_one_fold``,
``train_main``), validation and calibration wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..models.ctr_model import CTRModel, build_model
from ..models.layers import DropoutRNG
from .ema import EmaState, init_ema, make_ema_mask, update_ema
from .loss import bce_wll_style
from .sched import make_lr_schedule
from .sparse_embed import RowwiseAdagradState, init_rowwise_adagrad, rowwise_adagrad_update

__all__ = [
    "SEQ_TABLE",
    "TrainState",
    "build_model",
    "dense_params",
    "ema_filter_for",
    "is_sparse_mode",
    "make_eval_step",
    "make_optimizer",
    "make_train_state",
    "make_train_step",
    "step_seed",
]

# the lane-fused (V, 2D) sequence table: updated row-sparse, no EMA shadow
SEQ_TABLE = "dare.emb_tables"
SEQ_TABLES = ("emb_tables", "emb_att", "emb_rep")
SPARSE_EMB_OPTS = ("rowwise_adagrad", "sparse_sgd")


def is_sparse_mode(cfg) -> bool:
    return cfg.train.embedding_optimizer in SPARSE_EMB_OPTS


def _check_ported(cfg) -> None:
    t = cfg.train
    unported = {
        "train.embedding_optimizer other than rowwise_adagrad (dense-mode or sparse SGD "
        "tables)": t.embedding_optimizer != "rowwise_adagrad",
        "train.exact_dedup: false (the streaming scatter-add table update)":
            not bool(t.extra.get("exact_dedup", False)),
        "train.table_update: sweep": str(t.extra.get("table_update", "auto")) == "sweep",
        "loss.apply_extra_losses (rank / logit-l2 auxiliaries)":
            bool((cfg.loss or {}).get("apply_extra_losses", False)),
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported to tossctr_tpu_torch yet: {', '.join(asked)}")


def dense_params(model: CTRModel) -> Dict[str, torch.nn.Parameter]:
    """The parameters AdamW updates: every one but the sequence table."""
    return {n: p for n, p in model.named_parameters() if n != SEQ_TABLE}


def make_optimizer(cfg, steps_per_epoch: int):
    """-> (AdamW settings, schedule).  The settings are torch's AdamW
    arguments (the reference's torch defaults, as optax.adamw is given
    them); ``make_train_state`` builds the optimizer over the dense
    parameters, and the step sets its lr from ``schedule`` each step.
    There is no clip stage: the step clips the dense and row gradients
    together."""
    t = cfg.train
    schedule = make_lr_schedule(t.lr, warmup_steps=t.warmup_epochs * steps_per_epoch,
                                total_steps=t.epochs * steps_per_epoch, cosine=t.cosine)
    tx = dict(lr=float(t.lr), betas=(0.9, 0.999), eps=1e-8, weight_decay=float(t.weight_decay))
    return tx, schedule


def ema_filter_for(cfg) -> List[str]:
    """The configured EMA filter plus the sequence tables in sparse mode."""
    ema_filter = list(cfg.ema.param_filter)
    if is_sparse_mode(cfg):
        ema_filter += [x for x in SEQ_TABLES if x not in ema_filter]
    return ema_filter


@dataclass
class TrainState:
    model: CTRModel  # its parameters are the state's parameters
    opt: torch.optim.Optimizer  # AdamW over dense_params(model)
    ema: Optional[EmaState]
    step: int  # global step, 1-based after the first update
    table_opt: Dict[str, RowwiseAdagradState]

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def make_train_state(cfg, model: CTRModel, tx) -> TrainState:
    """The initial state of an initialised ``model``: AdamW over its dense
    parameters, the EMA shadow of the parameters the EMA mask tracks, and
    the table's (V, 2) AdaGrad accumulator."""
    _check_ported(cfg)
    if not cfg.model.fused_seq_tables:
        raise NotImplementedError("not ported to tossctr_tpu_torch yet: split sequence tables")
    dense = dense_params(model)
    opt = torch.optim.AdamW(list(dense.values()), **tx)
    params = dict(model.named_parameters())
    ema = init_ema(params, make_ema_mask(params, ema_filter_for(cfg))) if cfg.ema.enabled else None
    table_opt = {"emb_tables": init_rowwise_adagrad(model.dare.emb_tables)}
    return TrainState(model, opt, ema, 0, table_opt)


def step_seed(base_seed: int, step: int) -> int:
    """The seed of one step's dropout generators: the port's
    ``jax.random.fold_in(base_key, step)``."""
    return (int(base_seed) * 0x9E3779B1 + int(step) * 0x85EBCA77 + 1) % (2**63 - 1)


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: each leaf's sum of squares in the leaf's
    dtype (a bf16 leaf's squares and sum round to bf16), the total in
    fp32."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        sq = g * g
        total = total + sq.float().sum().to(g.dtype).float()
    return torch.sqrt(total)


def make_train_step(model: CTRModel, tx, cfg, base_seed: int,
                    schedule: Callable[[int], float]):
    """-> train_step(state, batch) -> (state, loss): one sparse-table
    step on ``batch`` (tensors on the model's device: X_num, X_mask,
    X_cat, seq, y and optionally valid), in place.  The loss is a device
    scalar: reading it is the caller's sync.  The EMA updates the
    parameters the state's shadow holds."""
    _check_ported(cfg)
    aux_w = float(cfg.model.qnn_alpha.aux_head_weight)
    clip = float(cfg.train.grad_clip_norm or 0.0)
    wd = float(cfg.train.weight_decay)
    pad_id = int(cfg.sequence.pad_id)
    ema_cfg = cfg.ema
    dense = list(dense_params(model).values())
    device = next(model.parameters()).device

    def total_loss(z, aux, y, valid):
        loss = bce_wll_style(z, y, valid=valid)
        if aux_w > 0:
            loss = loss + aux_w * bce_wll_style(aux, y, valid=valid)
        return loss

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        taps: dict = {}
        rng = DropoutRNG(step_seed(base_seed, state.step), device)
        for p in dense:
            p.grad = None
        z, _, aux = model(batch, rng=rng, taps=taps)
        loss = total_loss(z, aux, batch["y"], batch.get("valid"))
        loss.backward()
        for p in dense:  # optax decays a parameter that got no gradient too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        g_rows = taps["table_rows"].grad
        if clip > 0:  # one global norm over the dense AND the row gradients
            gn = _global_norm([p.grad for p in dense] + [g_rows])
            scale = torch.where(gn > clip, clip / (gn + 1e-6), torch.ones_like(gn))
            for p in dense:
                p.grad.mul_(scale)
            # JAX promotes bf16 rows times an fp32 scalar array to fp32;
            # torch would keep bf16 for a 0-d tensor, so promote explicitly
            g_rows = g_rows.float() * scale
        lr_t = schedule(state.step)
        for group in state.opt.param_groups:
            group["lr"] = lr_t
        state.opt.step()
        rowwise_adagrad_update(model.dare.emb_tables, state.table_opt["emb_tables"],
                               taps["sel_ids"], g_rows, lr=lr_t, pad_row=pad_id,
                               weight_decay=wd)
        state.step += 1
        if state.ema is not None:
            update_ema(state.ema, state.params(), state.step,
                       base_decay=float(ema_cfg.decay),
                       warmup_steps=int(ema_cfg.warmup_steps),
                       warmup_type=str(ema_cfg.warmup_type),
                       update_after_step=int(ema_cfg.update_after_step),
                       update_interval=int(ema_cfg.update_interval))
        return state, loss.detach()

    return train_step


def make_eval_step(model: CTRModel):
    """-> eval_step(params, batch) -> (logits, probabilities): a
    deterministic forward with ``params`` ({name: tensor}: the state's
    own, ``state.params()``, or its EMA weights, ``ema.ema_params(...)``)."""

    def eval_step(params, batch):
        with torch.inference_mode():
            z, p, _ = torch.func.functional_call(model, params, (batch,))
        return z, p

    return eval_step
