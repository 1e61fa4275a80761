"""The reference-shaped split sequence tables (``model.fused_seq_tables:
false``: ``emb_att`` scores, ``emb_rep`` represents, two (V, D) tables)
in the port against the JAX package, on the same converted parameters.

* The forward (fp32, one plain encoder layer, dropout off): logits,
  probabilities and the aux logit within 1e-6 absolute of the flax
  model's (the same fp32 arithmetic in another order).
* The converter and serving: a fold checkpoint written by the JAX
  package's ``save_fold_checkpoint`` (flax msgpack) with the two tables is
  read by ``train/flax_msgpack.py``, converted and served by
  ``infer/predict.py``'s ``predict_ensemble`` over a synthetic cache: ids
  in order and probabilities within 1e-6 of the flax model's.
* One sparse-table train step in each of the four table-update modes
  (exact dedup; the streaming scatter, ``exact_dedup: false``; the sweep,
  ``table_update: sweep``, whose JAX side runs ``sweep_rows_add`` in
  interpret mode over both tables at once and the port its plain version;
  ``sparse_sgd``), the tiny model without the encoder, fp32, every
  dropout off, the clip on.  The JAX side is the JAX package's sparse
  step as its ``make_train_step`` composes it with split tables (the
  loss and gradients of the dense parameters and the rows' perturbations,
  the clip over both, ``make_optimizer``'s AdamW, ``sparse_embed``'s and
  ``pallas_scatter``'s table updates), the model's program and the
  clip-and-AdamW program over the dense parameters each compiled once for
  the four modes, the table update's program once a mode.  Held: the loss within 1e-5 relative, both tables
  within 1e-5 relative (1e-6 absolute), each table's (V,) accumulator
  within 1e-5 relative, the dense parameters within 1e-5 relative where
  the gradient exceeds 1e-3 of its tensor's largest magnitude and
  elsewhere within the 2 lr that an Adam sign flip allows (the bands of
  ``test_torch_train_step.py``); only selected rows of either table
  change, never the pad row.

One test item (see ``_torch_helpers``).
"""

import copy

import numpy as np

from _torch_helpers import Checks, compiled, dims_for, flax_variables_from_port, make_batch
from _torch_helpers import SMALL_QNN, tiny_cfg_dict, torch_batch, torch_threads

LR = 1e-2
ROWS = 20  # the served cache: batches of 8, the last partial

MODES = {
    "exact dedup": dict(embedding_optimizer="rowwise_adagrad", exact_dedup=True),
    "streaming scatter": dict(embedding_optimizer="rowwise_adagrad", exact_dedup=False),
    "sweep": dict(embedding_optimizer="rowwise_adagrad", exact_dedup=False,
                  table_update="sweep"),
    "sparse_sgd": dict(embedding_optimizer="sparse_sgd", exact_dedup=False),
}


def split_cfg_dict(layers: int = 0, **train) -> dict:
    """The tiny config with split tables, every dropout off; ``layers``
    plain encoder layers (0: no encoder)."""
    return tiny_cfg_dict(amp="none", **{
        "sequence": {"transformer_block": layers > 0,
                     "tfm": {"n_layers": max(layers, 1), "mha_dropout": 0.0,
                             "ffn_dropout": 0.0}},
        "model": {"fused_seq_tables": False, "use_pallas_attention": False,
                  "use_pallas_ffn": False, "dare_dropout": 0.0, "embedding_dropout": 0.0,
                  "qnn_alpha": SMALL_QNN},
        "train": {"batch_size": 8, "epochs": 2, "warmup_epochs": 1, "lr": LR,
                  "weight_decay": 1e-2, "grad_clip_norm": 0.5, **train},
        "ema": {"enabled": False},
    })


def test_split_tables_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.ops import pallas_scatter as jscatter
    from tossctr_tpu.train import loss as jloss
    from tossctr_tpu.train import sparse_embed as jse
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu.train.checkpoint import save_fold_checkpoint
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict, load_flax_train_state
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.infer import predict_ensemble
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train import trainer

    def init(d, batch):
        """The flax model of ``d`` and the port's seeded parameters as its
        variables."""
        jmodel = jtrainer.build_model(JConfig.from_dict(copy.deepcopy(d)), dims_for(d))
        port = init_params(trainer.build_model(Config.from_dict(copy.deepcopy(d)), dims_for(d),
                                               device="cpu"), seed=3)
        b = {k: v for k, v in batch.items() if k != "y"}
        return jmodel, flax_variables_from_port(port, jmodel, b)

    def forward_and_serving():
        d = split_cfg_dict(layers=1, exp_name="split_serve",
                           logging={"log_dir": str(tmp_path / "runs")})
        cfg = Config.from_dict(copy.deepcopy(d))
        man = write_synth_cache_for(cfg, str(tmp_path / "cache"), ROWS, num_dim=5, seed=4)
        d["data"]["manifest_test"] = man
        cfg = Config.from_dict(copy.deepcopy(d))
        cache = ShardCache(man)
        batch = cache.gather(np.arange(8), train=False)
        batch.pop("ids")
        jmodel, variables = init(d, batch)
        assert {"emb_att", "emb_rep"} <= set(variables["params"]["dare"])
        assert "emb_tables" not in variables["params"]["dare"]
        apply = jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True))
        model = trainer.build_model(cfg, dims_for(d), device="cpu")
        model.load_state_dict(flax_to_state_dict(variables), strict=True)
        D = d["model"]["emb_dim"]
        assert model.dare.emb_att.shape == model.dare.emb_rep.shape == (300, D)
        with torch.inference_mode():
            got = [t.numpy() for t in model(torch_batch(batch))]
        want = [np.asarray(a) for a in apply(variables, batch)]
        for name, g, w in zip(("logits", "probabilities", "aux logit"), got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        # a JAX-written fold checkpoint served by the port
        jcfg = JConfig.from_dict(copy.deepcopy(d))
        save_fold_checkpoint(jcfg.exp_dir(), 0, params=variables, cfg_dict=jcfg.to_dict(),
                             best_score=0.5, epoch=1, global_step=3)
        served = predict_ensemble(cfg, cache, device="cpu")
        ids, probs = [], []
        for b in BatchIterator(cache, batch_size=8):  # the last batch padded, as served
            keep = b.pop("valid").astype(bool)
            ids.append(b.pop("ids")[keep])
            probs.append(np.asarray(apply(variables, b)[1])[keep])
        np.testing.assert_array_equal(served["ids"], np.concatenate(ids))
        np.testing.assert_allclose(served["probs"], np.concatenate(probs), rtol=0, atol=1e-6)

    base = split_cfg_dict(**MODES["streaming scatter"])
    dims = dims_for(base)
    batch = make_batch(base, B=8, seed=23)
    batch["y"] = (np.arange(8) % 3 == 1).astype(np.float32)
    variables, programs = {}, {}

    def gradients(jcfg, jmodel):
        """The JAX sparse step's loss and gradients (``make_train_step``'s
        ``value_and_grad`` over the dense parameters and the two tables'
        row perturbations), one program for the four modes."""
        if "grads" not in programs:
            K, D = 8, jcfg.model.emb_dim
            aux_w = float(jcfg.model.qnn_alpha.aux_head_weight)

            def fn(params, b):
                rest, tables = jtrainer.extract_tables(params)
                B = b["seq"].shape[0]
                perts0 = {"dare": {k: jnp.zeros((B, K, D), jnp.float32)
                                   for k in ("att_rows", "rep_rows")}}

                def loss_fn(rest_params, perts):
                    full = jtrainer.insert_tables(rest_params, tables)
                    (z, _, aux), vo = jmodel.apply({**full, "perturbations": perts}, b,
                                                   deterministic=True, mutable=["intermediates"])
                    inter = vo["intermediates"]["dare"]
                    loss = (jloss.bce_wll_style(z, b["y"])
                            + aux_w * jloss.bce_wll_style(aux, b["y"]))
                    fwd = {"emb_att": inter["att_rows_fwd"][0],
                           "emb_rep": inter["rep_rows_fwd"][0]}
                    return loss, (inter["sel_ids"][0], jax.lax.stop_gradient(fwd))

                (loss, aux), grads = jax.value_and_grad(loss_fn, argnums=(0, 1),
                                                        has_aux=True)(rest, perts0)
                return loss, aux, grads

            programs["grads"] = compiled(jax.jit(fn), variables_j(), batch_j())
        return programs["grads"]

    def variables_j():
        return jax.tree_util.tree_map(jnp.array, variables)

    def batch_j():
        return jax.tree_util.tree_map(jnp.asarray, batch)

    def jax_dense_update(jcfg, jtx):
        """The JAX sparse step's update of everything but the tables
        (``make_train_step``'s sparse branch): the clip over the dense and
        row gradients, then AdamW; -> (the new dense parameters, AdamW's
        state, the clipped row gradients).  The same in every table mode,
        so one program serves the four (the modes' configs differ only in
        the table update)."""
        clip = float(jcfg.train.grad_clip_norm)

        @jax.jit
        def update(params, opt_state, g_rest, g_perts):
            rest, _ = jtrainer.extract_tables(params)
            gn = optax.global_norm((g_rest, g_perts))
            scale = jnp.where(gn > clip, clip / (gn + 1e-6), 1.0)
            g_rest = jax.tree_util.tree_map(lambda g: g * scale, g_rest)
            g_rows = {"emb_att": g_perts["dare"]["att_rows"] * scale,
                      "emb_rep": g_perts["dare"]["rep_rows"] * scale}
            updates, opt_state = jtx.update(g_rest, opt_state, rest)
            return optax.apply_updates(rest, updates), opt_state, g_rows

        return update

    def jax_table_update(jcfg, jsched, mode):
        """Then the tables' update of ``mode``, as the sparse branch
        dispatches it."""
        t = jcfg.train
        wd, pad = float(t.weight_decay), jcfg.sequence.pad_id

        @jax.jit
        def update(state, rest, opt_state, sel_ids, fwd, g_rows):
            _, tables = jtrainer.extract_tables(state.params)
            lr_t = jsched(state.step)
            table_opt, new = dict(state.table_opt or {}), {}
            if mode == "sweep":
                names = list(g_rows)
                ts, accs = jscatter.rowwise_adagrad_sweep_update(
                    [tables[n] for n in names], [table_opt[n].accum for n in names], sel_ids,
                    [g_rows[n] for n in names], lr=lr_t, weight_decay=wd, pad_row=pad, halves=1)
                for n, tb, a in zip(names, ts, accs):
                    new[n], table_opt[n] = tb, jse.RowwiseAdagradState(accum=a)
            for n, g in g_rows.items():
                if mode == "sparse_sgd":
                    new[n] = jse.sparse_sgd_update(tables[n], sel_ids, g, lr=lr_t,
                                                   weight_decay=wd, pad_row=pad, rows=fwd[n])
                elif mode != "sweep":
                    new[n], table_opt[n] = jse.rowwise_adagrad_update(
                        tables[n], table_opt[n], sel_ids, g, lr=lr_t, weight_decay=wd,
                        pad_row=pad, exact_dedup=mode == "exact dedup", halves=1, rows=fwd[n])
            params = jtrainer.insert_tables(rest, new)
            return jtrainer.TrainState(params, opt_state, state.ema, state.step + 1,
                                       table_opt or None)

        return update

    def one_step(mode):
        d = split_cfg_dict(**MODES[mode])
        jcfg = JConfig.from_dict(copy.deepcopy(d))
        if not variables:
            jmodel, v = init(d, batch)
            variables.update(v)
            programs["model"] = jmodel
        jtx, jsched = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
        jstate, _ = jtrainer.make_train_state(jcfg, variables_j(), jtx)
        grads = gradients(jcfg, programs["model"])
        cfg = Config.from_dict(copy.deepcopy(d))
        model = trainer.build_model(cfg, dims, device="cpu")
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        state = trainer.make_train_state(cfg, model, tx)
        tables = trainer.seq_tables(model)
        assert set(tables) == {"emb_att", "emb_rep"}
        assert not any(t.requires_grad for t in tables.values())
        if mode == "sparse_sgd":
            assert state.table_opt == {}
        else:  # one (V,) accumulator a table
            assert {n: tuple(s.accum.shape) for n, s in state.table_opt.items()} == {
                "emb_att": (300,), "emb_rep": (300,)}
        load_flax_train_state(state, jax.device_get(jstate))
        step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)
        before = {n: t.detach().clone() for n, t in tables.items()}
        taps = {}
        with torch.no_grad():
            model(torch_batch(batch), taps=taps)
        assert set(taps) == {"sel_ids", "att_rows", "rep_rows"}
        selected = set(taps["sel_ids"].reshape(-1).tolist())

        jloss, (sel_ids, fwd), (g_rest, g_perts) = grads(jstate.params, batch_j())
        args = (jstate.params, jstate.opt_state, g_rest, g_perts)
        if "dense" not in programs:  # compiled once, for the four modes
            programs["dense"] = compiled(jax_dense_update(jcfg, jtx), *args)
        rest, opt_state, g_rows = programs["dense"](*args)
        args = (jstate, rest, opt_state, sel_ids, fwd, g_rows)
        jstate = compiled(jax_table_update(jcfg, jsched, mode), *args)(*args)
        state, loss = step(state, torch_batch(batch))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), (loss, jloss)
        jparams = flax_to_state_dict(jax.device_get(jstate.params))
        for n, p in model.named_parameters():
            got, want = p.detach().numpy(), jparams[n].numpy()
            if n in ("dare.emb_att", "dare.emb_rep"):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=n)
                continue
            g = np.abs(p.grad.numpy())
            big = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[big], want[big], rtol=1e-5, atol=1e-6, err_msg=n)
            assert np.abs(got - want).max() <= 2 * LR + 1e-6, n
        for n, s in state.table_opt.items():
            np.testing.assert_allclose(s.accum.numpy(), np.asarray(jstate.table_opt[n].accum),
                                       rtol=1e-5, atol=1e-12, err_msg=n)
        pad = cfg.sequence.pad_id
        for n, t in tables.items():
            changed = set(torch.nonzero((t != before[n]).any(dim=1))[:, 0].tolist())
            assert changed and changed <= selected - {pad}, (n, sorted(changed - selected))

    checks = Checks()
    with torch_threads():
        checks.run("forward, converter and serving", forward_and_serving)
        for mode in MODES:
            checks.run(f"train step, {mode}", one_step, mode)
    checks.done()
