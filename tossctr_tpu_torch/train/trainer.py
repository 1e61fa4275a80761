"""The train step (sparse-table and dense-table modes), the eval step and
the K-fold loop.

Port of ``tossctr_tpu/train/trainer.py``: ``build_model``,
``make_optimizer``, ``make_train_state``, ``make_train_step`` (both its
branches, in all their table-update modes), ``make_eval_step``,
``run_validation``, ``train_one_fold`` and ``train_main``.  The step is
an eager PyTorch function on the card:

  1. forward with every dropout of the config (kernel dropout seeds from
     a CPU generator seeded from (train seed, step): ``fold_in``),
  2. WLL-style BCE + ``aux_head_weight`` x the aux head's, and with
     ``loss.apply_extra_losses`` ``lambda_rank`` x the pairwise AUC loss
     (its negatives drawn from a generator seeded from the step seed) and
     ``lambda_logit_l2`` x the mean squared logit (over the valid rows),
  3. backward, through the kernels' backward kernels.
  Sparse-table mode (``train.embedding_optimizer`` rowwise_adagrad or
  sparse_sgd):
  4. the gradient of each sequence table's gathered rows (``models/dare.py``
     taps: the lane-fused table's, or the split att and rep tables'),
  5. global-norm clip over the dense and row gradients together,
  6. AdamW on the dense parameters, lr from the warmup + cosine schedule
     at the step the update starts from,
  7. each sequence table's row-sparse update, as the JAX sparse step
     dispatches it: row-wise AdaGrad with exact dedup, or streaming
     (``exact_dedup: false``, the default) through a scatter or, with
     ``train.table_update: sweep``, through the ``sweep_rows_add`` kernel
     (the split pair in one launch); or sparse SGD,
  8. EMA of the dense parameters (the tables have no shadow).
  Dense-table mode (``adamw``, the schema's default, ``adafactor`` or
  ``sgd``): the tables are trainable parameters,
  4. optax's ``clip_by_global_norm`` over every gradient,
  5. ``adamw``: one AdamW over every parameter; ``adafactor`` / ``sgd``:
     that optimizer (``train/adafactor.py``) on the table parameters (a
     flax path holding ``emb_att``, ``emb_rep``, ``emb_tables`` or
     ``table_``, the categorical tables too) and AdamW on the rest,
  6. EMA of every parameter the configured filter keeps, tables included.

The model's parameters are the state's parameters: the step updates
them in place.  The fold loop around it: the stratified group K-fold
split (``cv_split.py``), per-epoch validation on the EMA weights with
host metrics or, with ``eval.device_metrics: true``, the AP/WLL in torch
on the fold's device (``eval/metrics.py`` ``final_score_device``),
temperature and isotonic calibration, best-epoch checkpoints, early
stop, and step-granular resume.  Not ported (``_check_ported`` refuses
them, naming their ROADMAP item): the device mesh and distributed
runtime and ``debug_nans``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import ShardCache, load_labels_groups_for_split
from ..data.loader import BatchIterator, DevicePrefetcher
from ..data.sampler import BalancedBatchSampler
from ..eval.calibration import Calibrator
from ..eval.metrics import final_score, final_score_device
from ..models.ctr_model import (
    SPARSE_EMB_OPTS,
    CTRModel,
    build_model,
    init_params,
    resolve_device,
)
from ..models.layers import DropoutRNG
from ..utils.log import Logger
from ..utils.seed import set_seed
from .adafactor import SGD, Adafactor
from .checkpoint import (
    finalize_fold_checkpoint,
    fold_ckpt_exists,
    load_train_state,
    save_fold_checkpoint,
    save_train_state,
)
from .cv_split import StratifiedGroupKFold
from .ema import EmaState, ema_params, init_ema, make_ema_mask, update_ema
from .loss import bce_wll_style, logit_l2, pairwise_auc_loss
from .sched import make_lr_schedule
from .sparse_embed import (
    RowwiseAdagradState,
    init_rowwise_adagrad,
    rowwise_adagrad_sweep_update,
    rowwise_adagrad_update,
    sparse_sgd_update,
)

__all__ = [
    "SEQ_TABLE",
    "TrainState",
    "build_model",
    "dense_params",
    "ema_filter_for",
    "is_embedding_param",
    "is_sparse_mode",
    "make_eval_step",
    "make_optimizer",
    "make_train_state",
    "make_train_step",
    "run_validation",
    "seq_tables",
    "step_seed",
    "train_main",
    "train_one_fold",
]

# the lane-fused (V, 2D) sequence table, the default layout
SEQ_TABLE = "dare.emb_tables"
# the sequence tables (the fused one, or the split pair) and the tap of
# each one's gathered rows (models/dare.py)
SEQ_TABLES = ("emb_tables", "emb_att", "emb_rep")
ROW_TAPS = {"emb_tables": "table_rows", "emb_att": "att_rows", "emb_rep": "rep_rows"}
DENSE_EMB_OPTS = ("adamw", "adafactor", "sgd")
# a parameter whose flax path holds one of these takes the dense-mode
# table optimizer (the categorical table_{d} tables among them)
_EMB_MARKERS = ("emb_att", "emb_rep", "emb_tables", "table_")


def is_sparse_mode(cfg) -> bool:
    return cfg.train.embedding_optimizer in SPARSE_EMB_OPTS


def is_embedding_param(name: str) -> bool:
    """Whether the parameter ``name`` takes the dense-mode table optimizer:
    its flax path (``params/`` + the name with ``/`` for ``.``) holds a
    table marker."""
    path = "params/" + name.replace(".", "/")
    return any(m in path for m in _EMB_MARKERS)


def _check_ported(cfg) -> None:
    """Refuse a config that asks for what the port has not got yet, naming
    each part's ROADMAP item.  Selection needs nothing here: the JAX
    package's ``replicate_fn`` pins the proxy table replicated under
    sharding, and one device has no counterpart of it."""
    m = cfg.mesh
    unported = {
        "mesh.data > 1 or mesh.model > 1 (more than one device, ROADMAP queue 1 item 8)":
            m.data > 1 or m.model > 1,
        "extra.debug_nans (ROADMAP queue 1 item 8)": bool(cfg.extra.get("debug_nans", False)),
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported to tossctr_tpu_torch yet: {', '.join(asked)}")


def seq_tables(model: CTRModel) -> Dict[str, torch.nn.Parameter]:
    """{name: parameter} of the sequence tables: ``emb_tables``, or
    ``emb_att`` and ``emb_rep``."""
    return {n: getattr(model.dare, n) for n in SEQ_TABLES if hasattr(model.dare, n)}


def dense_params(model: CTRModel) -> Dict[str, torch.nn.Parameter]:
    """Every parameter but the sequence tables."""
    tables = {f"dare.{n}" for n in SEQ_TABLES}
    return {n: p for n, p in model.named_parameters() if n not in tables}


def make_optimizer(cfg, steps_per_epoch: int):
    """-> (AdamW settings, schedule).  The settings are torch's AdamW
    arguments (the reference's torch defaults, as optax.adamw is given
    them); ``make_train_state`` builds the optimizers (AdamW over the
    parameters it takes, and the dense-mode table optimizer), and the step
    sets their lr from ``schedule`` each step and clips the gradients
    itself."""
    t = cfg.train
    if t.embedding_optimizer not in SPARSE_EMB_OPTS + DENSE_EMB_OPTS:
        raise ValueError(f"unknown embedding_optimizer {t.embedding_optimizer}")
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
    opt: torch.optim.Optimizer  # AdamW over the parameters it takes
    ema: Optional[EmaState]
    step: int  # global step, 1-based after the first update
    table_opt: Dict[str, RowwiseAdagradState]  # sparse AdaGrad's, by table; else empty
    emb_opt: Optional[Any] = None  # the dense-mode Adafactor or SGD of the tables

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def make_train_state(cfg, model: CTRModel, tx) -> TrainState:
    """The initial state of an initialised ``model``: the optimizers, the
    EMA shadow of the parameters the EMA mask tracks, and in sparse mode
    the tables' optimizer state: each table's AdaGrad accumulator ((V, 2)
    for the lane-fused table, (V,) for a split one), none for sparse SGD.
    AdamW takes the dense parameters (sparse mode), every parameter
    (``adamw``), or those ``is_embedding_param`` leaves to ``adafactor`` /
    ``sgd``."""
    _check_ported(cfg)
    emb_opt = cfg.train.embedding_optimizer
    params = dict(model.named_parameters())
    table_opt, emb = {}, None
    if is_sparse_mode(cfg):
        adam = list(dense_params(model).values())
        if emb_opt == "rowwise_adagrad":
            table_opt = {n: init_rowwise_adagrad(t, halves=2 if n == "emb_tables" else 1)
                         for n, t in seq_tables(model).items()}
    elif emb_opt == "adamw":
        adam = list(params.values())
    else:
        adam = [p for n, p in params.items() if not is_embedding_param(n)]
        tables = {n: p for n, p in params.items() if is_embedding_param(n)}
        emb = Adafactor(tables) if emb_opt == "adafactor" else SGD(tables)
    opt = torch.optim.AdamW(adam, **tx)
    ema = init_ema(params, make_ema_mask(params, ema_filter_for(cfg))) if cfg.ema.enabled else None
    return TrainState(model, opt, ema, 0, table_opt, emb)


def step_seed(base_seed: int, step: int) -> int:
    """The seed of one step's dropout generators: the port's
    ``jax.random.fold_in(base_key, step)``."""
    return (int(base_seed) * 0x9E3779B1 + int(step) * 0x85EBCA77 + 1) % (2**63 - 1)


def rank_seed(step_seed_: int) -> int:
    """The seed of one step's pairwise-loss draws, apart from its dropout
    seed (the JAX step splits its key in two)."""
    return (int(step_seed_) * 0x2545F491 + 0x6A09E667) % (2**63 - 1)


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
    """-> train_step(state, batch) -> (state, loss): one train step on
    ``batch`` (tensors on the model's device: X_num, X_mask, X_cat, seq, y
    and optionally valid), in place, in the config's table mode (module
    docstring).  The loss is a device scalar: reading it is the caller's
    sync.  The EMA updates the parameters the state's shadow holds."""
    _check_ported(cfg)
    emb_opt = cfg.train.embedding_optimizer
    sparse = is_sparse_mode(cfg)
    exact_dedup = bool(cfg.train.extra.get("exact_dedup", False))
    table_update = str(cfg.train.extra.get("table_update", "auto"))
    if sparse and table_update == "sweep" and exact_dedup:
        raise ValueError(
            "train.table_update: 'sweep' is incompatible with train.exact_dedup: true (the "
            "sweep kernel implements the streaming scatter-add path) -- disable one explicitly"
        )
    # "auto" takes the scatter, as the JAX step does; the sweep serves the
    # AdaGrad tables only
    use_sweep = emb_opt == "rowwise_adagrad" and table_update == "sweep"
    aux_w = float(cfg.model.qnn_alpha.aux_head_weight)
    loss_cfg = cfg.loss or {}
    # the reference defines the rank and logit-l2 auxiliaries but does not
    # call them; apply_extra_losses opts in
    extra = bool(loss_cfg.get("apply_extra_losses", False))
    lam_rank = float(loss_cfg.get("lambda_rank", 0.0)) if extra else 0.0
    lam_l2 = float(loss_cfg.get("lambda_logit_l2", 0.0)) if extra else 0.0
    n_neg = int(loss_cfg.get("num_neg_per_pos", 8))
    hard_frac = float(loss_cfg.get("hard_neg_frac", 0.0))
    clip = float(cfg.train.grad_clip_norm or 0.0)
    wd = float(cfg.train.weight_decay)
    pad_id = int(cfg.sequence.pad_id)
    ema_cfg = cfg.ema
    tables = seq_tables(model)
    # the parameters this step's gradients land on
    trained = list((dense_params(model) if sparse else dict(model.named_parameters())).values())
    device = next(model.parameters()).device

    def total_loss(z, aux, y, valid, seed):
        loss = bce_wll_style(z, y, valid=valid)
        if aux_w > 0:
            loss = loss + aux_w * bce_wll_style(aux, y, valid=valid)
        if lam_rank > 0:
            gen = torch.Generator(device=z.device).manual_seed(rank_seed(seed))
            loss = loss + lam_rank * pairwise_auc_loss(z, y, gen, num_neg_per_pos=n_neg,
                                                       hard_frac=hard_frac, valid=valid)
        if lam_l2 > 0:
            if valid is None:
                loss = loss + lam_l2 * logit_l2(z)
            else:  # the mean over the valid rows
                v = valid.float()
                loss = loss + lam_l2 * ((z.float() ** 2 * v).sum() / v.sum().clamp(min=1.0))
        return loss

    def forward_backward(state, batch, taps):
        seed = step_seed(base_seed, state.step)
        rng = DropoutRNG(seed, device)
        for p in trained:
            p.grad = None
        z, _, aux = model(batch, rng=rng, taps=taps)
        loss = total_loss(z, aux, batch["y"], batch.get("valid"), seed)
        loss.backward()
        for p in trained:  # optax decays a parameter that got no gradient too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss

    def finish(state, loss):
        state.step += 1
        if state.ema is not None:
            update_ema(state.ema, state.params(), state.step,
                       base_decay=float(ema_cfg.decay),
                       warmup_steps=int(ema_cfg.warmup_steps),
                       warmup_type=str(ema_cfg.warmup_type),
                       update_after_step=int(ema_cfg.update_after_step),
                       update_interval=int(ema_cfg.update_interval))
        return state, loss.detach()

    def adam_step(state, lr_t):
        for group in state.opt.param_groups:
            group["lr"] = lr_t
        state.opt.step()

    def dense_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss = forward_backward(state, batch, None)
        if clip > 0:  # optax's clip_by_global_norm, in each gradient's dtype
            gn = _global_norm([p.grad for p in trained])
            keep = gn < clip
            for p in trained:
                p.grad = torch.where(keep, p.grad, p.grad / gn.to(p.grad.dtype) * clip)
        lr_t = schedule(state.step)
        adam_step(state, lr_t)
        if state.emb_opt is not None:
            state.emb_opt.step(lr_t)
        return finish(state, loss)

    def sparse_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        taps: dict = {}
        loss = forward_backward(state, batch, taps)
        g_rows = {n: taps[ROW_TAPS[n]].grad for n in tables}
        if clip > 0:  # one global norm over the dense AND the row gradients
            gn = _global_norm([p.grad for p in trained] + list(g_rows.values()))
            scale = torch.where(gn > clip, clip / (gn + 1e-6), torch.ones_like(gn))
            for p in trained:
                p.grad.mul_(scale)
            # JAX promotes bf16 rows times an fp32 scalar array to fp32;
            # torch would keep bf16 for a 0-d tensor, so promote explicitly
            g_rows = {n: g.float() * scale for n, g in g_rows.items()}
        lr_t = schedule(state.step)
        adam_step(state, lr_t)
        ids = taps["sel_ids"]
        if use_sweep:  # every table's rows in one sweep_rows_add launch
            # the sweep's decay reads fresh rows of the tables, as the JAX one's
            rowwise_adagrad_sweep_update(list(tables.values()),
                                         [state.table_opt[n] for n in tables], ids,
                                         list(g_rows.values()), lr=lr_t, pad_row=pad_id,
                                         weight_decay=wd)
            return finish(state, loss)
        for n, table in tables.items():
            # the forward rows serve the lazy decay only where they lose
            # nothing against a fresh fp32 gather: a table stored in the
            # compute dtype
            fwd_rows = taps[ROW_TAPS[n]].detach()
            reuse = fwd_rows if table.dtype == fwd_rows.dtype else None
            if emb_opt == "rowwise_adagrad":
                rowwise_adagrad_update(table, state.table_opt[n], ids, g_rows[n], lr=lr_t,
                                       pad_row=pad_id, weight_decay=wd,
                                       exact_dedup=exact_dedup, rows=reuse)
            else:
                sparse_sgd_update(table, ids, g_rows[n], lr=lr_t, pad_row=pad_id,
                                  weight_decay=wd, rows=reuse)
        return finish(state, loss)

    return sparse_step if sparse else dense_step


def make_eval_step(model: CTRModel):
    """-> eval_step(params, batch) -> (logits, probabilities): a
    deterministic forward with ``params`` ({name: tensor}: the state's
    own, ``state.params()``, or its EMA weights, ``ema.ema_params(...)``)."""

    def eval_step(params, batch):
        with torch.inference_mode():
            z, p, _ = torch.func.functional_call(model, params, (batch,))
        return z, p

    return eval_step


def run_validation(eval_step, params, loader, device) -> Tuple[torch.Tensor, torch.Tensor,
                                                                torch.Tensor]:
    """-> (y_true, p_raw, z_raw) over ``loader``, padded rows dropped by
    the ``valid`` mask, as tensors on ``device``: the caller moves them to
    the host once, if at all."""
    zs, ps, ys, valids = [], [], [], []
    for batch in DevicePrefetcher(loader, device):
        z, p = eval_step(params, batch)
        zs.append(z)
        ps.append(p)
        ys.append(batch["y"])
        valids.append(batch["valid"])
    if not zs:
        empty = torch.zeros(0, device=device)
        return empty, empty, empty
    z, p, y, valid = (torch.cat(t) for t in (zs, ps, ys, valids))
    keep = valid.bool()
    return y[keep], p[keep], z[keep]


def train_one_fold(cfg, fold: int, idx_tr: np.ndarray, idx_va: np.ndarray, manifest_path: str,
                   logger: Logger, device="cuda") -> Dict[str, Any]:
    """Train one fold on ``device``: -> the best epoch's record (score,
    epoch, global_step, persisted).  The best epoch's weights, EMA weights
    and calibrator are written to the fold checkpoint when they are found
    (``complete=False``); ``train_main`` stamps it complete.  With
    ``train.step_checkpointing`` the train state is saved after every
    epoch (and every ``step_checkpoint_interval`` steps), and a fold
    started again resumes from it: the samplers are pure functions of
    (seed, epoch) and the step's dropout of (seed, step), so a resumed
    fold repeats the uninterrupted one's trajectory."""
    _check_ported(cfg)
    t = cfg.train
    dev = resolve_device(device)
    cache = ShardCache(manifest_path)
    if cfg.sampler.balanced:
        sampler = BalancedBatchSampler(
            cache.labels()[idx_tr], batch_size=t.batch_size,
            pos_fraction=float(cfg.sampler.pos_fraction), seed=int(cfg.seed),
            # the reference never reseeds; the loop does unless told not to
            reseed_each_epoch=bool((cfg.sampler.extra or {}).get("reseed_each_epoch", True)))
        tr_loader = BatchIterator(cache, idx_tr, batch_size=t.batch_size, train=True,
                                  sampler=sampler)
    else:
        # the final partial batch is trained on (padded, valid-masked)
        # unless train.drop_partial_batch
        tr_loader = BatchIterator(cache, idx_tr, batch_size=t.batch_size, train=True,
                                  shuffle=True, seed=cfg.seed,
                                  drop_last=bool(t.drop_partial_batch))
    va_loader = BatchIterator(cache, idx_va, batch_size=t.batch_size, train=True,
                              shuffle=False, drop_last=False)

    model = init_params(build_model(cfg, cache.dims, dev), seed=cfg.seed + 101 * fold)
    steps_per_epoch = len(tr_loader)
    tx, schedule = make_optimizer(cfg, steps_per_epoch)
    state = make_train_state(cfg, model, tx)
    train_step = make_train_step(model, tx, cfg, base_seed=cfg.seed + 7919 * fold,
                                 schedule=schedule)
    eval_step = make_eval_step(model)

    use_ema_eval = cfg.ema.enabled and cfg.ema.eval_with_ema
    best = {"score": -1e9, "epoch": 0, "global_step": 0, "persisted": False}
    wait = 0
    start_epoch, resume_skip = 1, 0
    exp_dir = cfg.exp_dir()
    state_path = os.path.join(exp_dir, f"fold_{fold}_state.pt")
    ckpt_every = int(t.step_checkpoint_interval or 0)
    if t.step_checkpointing and os.path.exists(state_path):
        saved = load_train_state(state_path, state)
        sie = int(saved["step_in_epoch"])
        if sie > 0:  # a mid-epoch save: re-enter that epoch after its first sie steps
            start_epoch, resume_skip = int(saved["epoch"]), sie
        else:
            start_epoch = int(saved["epoch"]) + 1
        wait = int(saved["wait"])
        best.update(score=float(saved["best_score"]), epoch=int(saved["best_epoch"]),
                    global_step=int(saved["best_global_step"]), persisted=True)
        logger.row(fold=fold, split="resume", epoch=start_epoch,
                   msg=f"in-fold resume (step {resume_skip})" if resume_skip
                   else "in-fold resume")

    def save_state(epoch: int, step_in_epoch: int):
        save_train_state(state_path, state, epoch=epoch, wait=wait, step_in_epoch=step_in_epoch,
                         best_score=best["score"], best_epoch=best["epoch"],
                         best_global_step=best["global_step"])

    for epoch in range(start_epoch, t.epochs + 1):
        tr_loader.set_epoch(epoch)
        losses = []
        t0 = time.time()
        skip = resume_skip if epoch == start_epoch else 0
        step_in_epoch = skip
        for batch in DevicePrefetcher(tr_loader.batches(skip), dev):
            state, loss = train_step(state, batch)
            losses.append(loss)
            step_in_epoch += 1
            if (t.step_checkpointing and ckpt_every > 0 and step_in_epoch % ckpt_every == 0
                    and step_in_epoch < steps_per_epoch):
                save_state(epoch, step_in_epoch)
        losses = torch.stack(losses).tolist() if losses else []
        dt = time.time() - t0
        global_step = state.step
        examples = (step_in_epoch - skip) * t.batch_size
        logger.throughput(f"fold{fold}", epoch, examples, dt)

        params = state.params()
        eval_p = ema_params(state.ema, params) if use_ema_eval else params
        y_val, p_val, z_val = run_validation(eval_step, eval_p, va_loader, dev)
        y_true, p_raw, z_raw = (t.cpu().numpy() for t in (y_val, p_val, z_val))
        # true: the AP/WLL on the fold's device, from the scores there; null
        # (auto): the host's, as the JAX package resolves it off a TPU
        if cfg.eval.device_metrics:
            ap, wll, score = final_score_device(y_val, p_val, formula=cfg.eval.score_formula,
                                                device=dev)
        else:
            ap, wll, score = final_score(y_true, p_raw, formula=cfg.eval.score_formula)

        cal = None
        ap_cal = wll_cal = score_cal = None
        if cfg.calibration.enabled:
            c = cfg.calibration
            cal = Calibrator(method=c.method, lr=c.lr, iters=c.iters, clamp_T=c.clamp_T,
                             l2_reg=c.l2_reg, min_iso_nodes=c.min_iso_nodes).fit(z_raw, y_true)
            ap_cal, wll_cal, score_cal = final_score(y_true, cal.predict_proba(z_raw),
                                                     formula=cfg.eval.score_formula)

        lr_now = float(schedule(global_step - 1)) if global_step > 0 else t.lr
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        row = dict(fold=fold, epoch=epoch, split="val", loss=round(mean_loss, 6),
                   AP=round(ap, 6), WLL=round(wll, 6), Score=round(score, 6),
                   lr=f"{lr_now:.3e}", bs=t.batch_size, K=cfg.sequence.top_k,
                   tau=cfg.sequence.recency_tau)
        logger.row(**row, eps=f"{examples / max(dt, 1e-9):.0f}/s")
        logger.csv(**row)
        logger.scalars(f"fold{fold}", epoch, train_loss=mean_loss, val_AP=ap, val_WLL=wll,
                       val_Score=score)
        if cfg.calibration.enabled:
            logger.row(fold=fold, epoch=epoch, split="val_cal", loss="--", AP=round(ap_cal, 6),
                       WLL=round(wll_cal, 6), Score=round(score_cal, 6))
            logger.csv(fold=fold, epoch=epoch, split="val_cal", loss="--", AP=ap_cal,
                       WLL=wll_cal, Score=score_cal, lr=f"{lr_now:.3e}", bs=t.batch_size,
                       K=cfg.sequence.top_k, tau=cfg.sequence.recency_tau)
            logger.scalars(f"fold{fold}", epoch, val_WLL_cal=wll_cal, val_Score_cal=score_cal)

        cur = score_cal if (cfg.calibration.enabled and score_cal is not None) else score
        if cur > best["score"]:
            best = {"score": float(cur), "epoch": int(epoch), "global_step": global_step,
                    "persisted": True}
            wait = 0
            # written at once, the EMA weights validation scored beside the
            # live ones; meta.json is stamped when the fold ends
            save_fold_checkpoint(
                exp_dir, fold, state_dict=model.state_dict(), cfg_dict=cfg.to_dict(),
                best_score=float(cur), epoch=int(epoch), global_step=global_step,
                ema=(None if state.ema is None else
                     {n: s.to(params[n].dtype) for n, s in state.ema.shadow.items()}),
                calibrator=cal, complete=False)
        else:
            wait += 1

        if t.step_checkpointing:
            save_state(epoch, 0)
        if wait >= t.early_stop_patience:
            break

    if t.step_checkpointing and os.path.exists(state_path):
        os.remove(state_path)
    return best


def train_main(cfg, device="cuda") -> str:
    """K-fold training on ``device``: the stratified group split of the
    train cache into ``max(5, cv.n_splits)`` folds (only the first with
    ``n_splits: 1``), each fold trained unless its checkpoint is complete
    (fold-skip resume), then stamped complete.  -> the experiment
    directory."""
    dev = resolve_device(device)
    _check_ported(cfg)
    os.makedirs(cfg.logging.log_dir, exist_ok=True)
    set_seed(cfg.seed, deterministic=cfg.deterministic)
    exp_dir = cfg.exp_dir()
    logger = Logger(exp_dir, tb=cfg.logging.tb, csv_log=cfg.logging.csv_log)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.row(split="device", msg=f"{dev} ({name})")

    manifest_path = cfg.data.manifest_train or os.path.join(cfg.data.cache_dir, "train",
                                                            "manifest.json")
    y, groups = load_labels_groups_for_split(manifest_path)
    n_splits = int(cfg.cv.n_splits)
    sgkf = StratifiedGroupKFold(n_splits=max(5, n_splits), shuffle=True, random_state=cfg.seed)
    for fold, (tr, va) in enumerate(sgkf.split(np.zeros_like(y), y, groups)):
        if n_splits == 1 and fold > 0:
            break
        if fold_ckpt_exists(exp_dir, fold):
            logger.row(fold=fold, split="skip", msg="checkpoint exists (resume)")
            continue
        best = train_one_fold(cfg, fold, tr, va, manifest_path, logger, dev)
        if not best.get("persisted"):
            raise RuntimeError(f"fold {fold} produced no best state")
        finalize_fold_checkpoint(exp_dir, fold, cfg_dict=cfg.to_dict(), best_score=best["score"],
                                 epoch=best["epoch"], global_step=best["global_step"])
        logger.row(fold=fold, split="done", Score=round(best["score"], 6))
    return exp_dir
