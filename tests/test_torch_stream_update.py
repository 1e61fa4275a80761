"""The streaming table updates of the port against the JAX package's
``train/sparse_embed.py`` and sparse train step.

* ``rowwise_adagrad_update(exact_dedup=False)``, the no-sort path (the
  accumulator takes each occurrence's per-half mean g^2, each occurrence
  is scaled by its row's post-accumulation statistic, the decay is lazy),
  with the decay's rows gathered afresh and with the forward rows passed
  in, and ``sparse_sgd_update`` with and without them, on a (300, 32)
  table of two halves with duplicate ids, a hot id and the pad id among
  them.  fp32: the table and the accumulator within 1e-6 of each one's
  largest magnitude.  bf16 tables: bit-equal, since on the CPU both
  packages add a row's deltas one at a time in index order in bf16
  (XLA's scatter, the port's ``index_put_`` with ``accumulate``).
* One train step of the tiny model (without the encoder) in each of the
  three modes the JAX
  sparse step dispatches (``exact_dedup: false`` through the scatter;
  with ``table_update: sweep`` through ``sweep_rows_add``, whose JAX side
  runs the Pallas kernel in interpret mode; ``embedding_optimizer:
  sparse_sgd``), fp32, every dropout off, from one JAX state carried
  across: the loss within 1e-4, the table within 1e-5 relative (1e-6
  absolute), the accumulator within 1e-5, the dense parameters within
  1e-5 relative where the gradient exceeds 1e-3 of its tensor's largest
  magnitude and elsewhere within the 2 lr that an Adam sign flip allows
  (the bands of ``test_torch_train_step.py``); only selected rows change,
  never the pad row.  The sparse-SGD state (no accumulator) goes through
  ``save_train_state`` / ``load_train_state``.
* ``table_update: sweep`` with ``exact_dedup: true`` raises ValueError in
  both packages.

One test item (see ``_torch_helpers``).
"""

import copy

import numpy as np
import pytest

from _torch_helpers import Checks, dims_for, make_batch, tiny_cfg_dict, torch_batch, torch_threads

LR = 1e-2
V, W, N, PAD = 300, 32, 160, 0


def step_cfg_dict(**train):
    """The tiny model without the encoder (its paths have tests of their
    own), every dropout off, the given table-update settings."""
    return tiny_cfg_dict(amp="none", **{
        "sequence": {"transformer_block": False},
        "model": {"dare_dropout": 0.0, "embedding_dropout": 0.0, "qnn_alpha": {"dropout": 0.0}},
        "train": {"batch_size": 8, "epochs": 2, "warmup_epochs": 1, "lr": LR,
                  "weight_decay": 1e-2, "grad_clip_norm": 0.5, **train},
        "ema": {"enabled": False},
    })


MODES = {
    "exact_dedup false (scatter)": dict(embedding_optimizer="rowwise_adagrad",
                                        exact_dedup=False),
    "table_update sweep": dict(embedding_optimizer="rowwise_adagrad", exact_dedup=False,
                               table_update="sweep"),
    "sparse_sgd": dict(embedding_optimizer="sparse_sgd", exact_dedup=False),
}


def update_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, N).astype(np.int32)
    ids[::7] = PAD
    ids[1::9] = 42  # a hot row
    table = rng.normal(0, 1, (V, W)).astype(np.float32)
    accum = rng.uniform(0, 0.5, (V, 2)).astype(np.float32)
    g = rng.normal(0, 0.3, (N, W)).astype(np.float32)
    if dtype == "bf16":  # values a bf16 table holds exactly
        import ml_dtypes

        table = table.astype(ml_dtypes.bfloat16).astype(np.float32)
    return ids, table, accum, g


def test_streaming_updates_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.train import sparse_embed as jse
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict, load_flax_train_state
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.train import sparse_embed as tse
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.checkpoint import load_train_state, save_train_state

    def tables(table, dtype):
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                            torch.float32)
        return jnp.asarray(table, jdt), torch.from_numpy(table).to(tdt)

    def hold_rows(name, dtype, got, want):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        if dtype == "f32":
            err = float(np.abs(got - want).max())
            assert err <= 1e-6 * float(np.abs(want).max()), f"{name}: {err}"
        else:
            assert np.array_equal(got, want), f"{name}: {int((got != want).sum())} differ"

    def adagrad(dtype, with_rows):
        ids, table, accum, g = update_inputs(1, dtype)
        jt, tt = tables(table, dtype)
        mask = (ids != PAD)[:, None]
        rows = (table[ids] * mask) if with_rows else None
        jt, jstate = jse.rowwise_adagrad_update(
            jt, jse.RowwiseAdagradState(jnp.asarray(accum)), jnp.asarray(ids), jnp.asarray(g),
            lr=0.05, weight_decay=0.01, pad_row=PAD, exact_dedup=False, halves=2,
            rows=None if rows is None else jnp.asarray(rows, jt.dtype))
        state = tse.RowwiseAdagradState(torch.from_numpy(accum.copy()))
        tse.rowwise_adagrad_update(
            tt, state, torch.from_numpy(ids), torch.from_numpy(g), lr=0.05, pad_row=PAD,
            weight_decay=0.01, exact_dedup=False,
            rows=None if rows is None else torch.from_numpy(rows).to(tt.dtype))
        hold_rows("table", dtype, tt.float().numpy(), np.asarray(jt, np.float32))
        hold_rows("accum", "f32", state.accum.numpy(), np.asarray(jstate.accum))
        assert np.array_equal(tt.float().numpy()[PAD], table[PAD]), "the pad row moved"

    def sgd(dtype, with_rows):
        ids, table, _, g = update_inputs(2, dtype)
        jt, tt = tables(table, dtype)
        rows = (table[ids] * (ids != PAD)[:, None]) if with_rows else None
        jt = jse.sparse_sgd_update(jt, jnp.asarray(ids), jnp.asarray(g), lr=0.05,
                                   weight_decay=0.01, pad_row=PAD,
                                   rows=None if rows is None else jnp.asarray(rows, jt.dtype))
        tse.sparse_sgd_update(tt, torch.from_numpy(ids), torch.from_numpy(g), lr=0.05,
                              pad_row=PAD, weight_decay=0.01,
                              rows=None if rows is None else torch.from_numpy(rows).to(tt.dtype))
        hold_rows("table", dtype, tt.float().numpy(), np.asarray(jt, np.float32))
        assert np.array_equal(tt.float().numpy()[PAD], table[PAD]), "the pad row moved"

    # ---- one train step of the tiny model in each mode ----
    base = step_cfg_dict(**MODES["exact_dedup false (scatter)"])
    dims = dims_for(base)
    batch = make_batch(base, B=8, seed=21)
    batch["y"] = (np.arange(8) % 3 == 0).astype(np.float32)
    init = {k: v for k, v in batch.items() if k != "y"}
    jmodel0 = jtrainer.build_model(JConfig.from_dict(copy.deepcopy(base)), dims)
    variables = jtrainer.jitted_init(jmodel0, jax.random.PRNGKey(0), init)

    def one_step(mode):
        d = step_cfg_dict(**MODES[mode])
        jcfg = JConfig.from_dict(copy.deepcopy(d))
        jtx, jsched = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
        # a copy: the JAX step donates its state's buffers
        jstate, jmask = jtrainer.make_train_state(
            jcfg, jax.tree_util.tree_map(jnp.array, variables), jtx)
        jstep = jtrainer.make_train_step(jtrainer.build_model(jcfg, dims), jtx, jcfg,
                                         jax.random.PRNGKey(1), ema_mask=jmask,
                                         schedule=jsched)
        cfg = Config.from_dict(copy.deepcopy(d))
        model = trainer.build_model(cfg, dims, device="cpu")
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        state = trainer.make_train_state(cfg, model, tx)
        assert (set(state.table_opt) == {"emb_tables"}) == (mode != "sparse_sgd")
        load_flax_train_state(state, jax.device_get(jstate))
        step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)
        table0 = model.dare.emb_tables.detach().clone()
        taps = {}
        with torch.no_grad():
            model(torch_batch(batch), taps=taps)
        selected = set(taps["sel_ids"].reshape(-1).tolist())

        jstate, jloss = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        reset_launch_counts()
        state, loss = step(state, torch_batch(batch))
        assert not any(launch_counts().values())  # CPU: the plain versions
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss)), (loss, jloss)
        jparams = flax_to_state_dict(jax.device_get(jstate.params))
        for n, p in model.named_parameters():
            got, want = p.detach().numpy(), jparams[n].numpy()
            if n == trainer.SEQ_TABLE:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=n)
                continue
            g = np.abs(p.grad.numpy())
            big = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[big], want[big], rtol=1e-5, atol=1e-6, err_msg=n)
            assert np.abs(got - want).max() <= 2 * LR + 1e-6, n
        for n, t in state.table_opt.items():
            np.testing.assert_allclose(t.accum.numpy(), np.asarray(jstate.table_opt[n].accum),
                                       rtol=1e-5, atol=1e-12)
        changed = set(torch.nonzero((model.dare.emb_tables != table0).any(dim=1))[:, 0].tolist())
        assert changed and changed <= selected - {PAD}, sorted(changed - selected)
        if mode == "sparse_sgd":  # the state without an accumulator saves and loads
            path = str(tmp_path / "sgd_state.pt")
            save_train_state(path, state, epoch=1)
            fresh = trainer.make_train_state(cfg, trainer.build_model(cfg, dims, device="cpu"),
                                             tx)
            assert load_train_state(path, fresh) == {"epoch": 1}
            assert fresh.table_opt == {} and fresh.step == state.step
            assert torch.equal(fresh.model.dare.emb_tables, model.dare.emb_tables)

    def sweep_with_exact_dedup_raises():
        d = step_cfg_dict(embedding_optimizer="rowwise_adagrad", exact_dedup=True,
                          table_update="sweep")
        cfg = Config.from_dict(copy.deepcopy(d))
        model = trainer.build_model(cfg, dims, device="cpu")
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        with pytest.raises(ValueError, match="sweep"):
            trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)
        jcfg = JConfig.from_dict(copy.deepcopy(d))
        jtx, jsched = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
        with pytest.raises(ValueError, match="sweep"):
            jtrainer.make_train_step(jmodel0, jtx, jcfg, jax.random.PRNGKey(1), ema_mask=None,
                                     schedule=jsched)

    checks = Checks()
    with torch_threads():
        for dtype in ("f32", "bf16"):
            for with_rows in (False, True):
                checks.run(f"no-sort adagrad {dtype} rows={with_rows}", adagrad, dtype, with_rows)
                checks.run(f"sparse sgd {dtype} rows={with_rows}", sgd, dtype, with_rows)
        for mode in MODES:
            checks.run(f"train step, {mode}", one_step, mode)
        checks.run("sweep with exact dedup raises", sweep_with_exact_dedup_raises)
    checks.done()
