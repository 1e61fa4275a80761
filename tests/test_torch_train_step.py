"""The port's sparse-table train step against the JAX package's, in fp32
with every dropout off, both started from one state (the JAX
``TrainState`` carried across by ``convert.load_flax_train_state``), the
encoder kernels on both sides (Pallas in interpret mode on the JAX side):

* the loss and its gradients w.r.t. every dense parameter and the
  gathered table rows against ``jax.value_and_grad`` of the sparse step's
  loss (WLL-style BCE + 0.1 x the aux head's), within 1e-4 of each
  tensor's largest magnitude;
* then two whole ``make_train_step`` calls on each side (the second on a
  partial batch with a ``valid`` mask): the losses, the dense parameters,
  the table and its AdaGrad accumulator, the EMA shadow and the step;
* ``make_eval_step`` on the JAX state's parameters against the JAX eval
  step, within 1e-4.

Adam's first steps move a parameter by about lr x sign(g), so where a
gradient is near zero a rounding difference can flip its sign and the
two sides then differ by up to 2 lr.  Dense parameters are therefore held
to 1e-5 relative only where every step's gradient exceeds 1e-3 of its
tensor's largest magnitude, and elsewhere to the 2 lr x steps that sign
flips allow.  One test item (see ``_torch_helpers``).
"""

import copy

import numpy as np

from _torch_helpers import (
    Checks,
    compiled,
    dims_for,
    jax_model_and_variables,
    make_batch,
    tiny_cfg_dict,
    torch_batch,
    torch_threads,
)

LR = 1e-2
AUX_W = 0.1


def train_cfg_dict():
    return tiny_cfg_dict(amp="none", **{
        "sequence": {"tfm": {"n_layers": 1, "mha_dropout": 0.0, "ffn_dropout": 0.0}},
        "model": {"dare_dropout": 0.0, "embedding_dropout": 0.0, "dropout_impl": "hash",
                  "qnn_alpha": {"dropout": 0.0, "aux_head_weight": AUX_W}},
        "train": {"batch_size": 8, "epochs": 2, "warmup_epochs": 1, "lr": LR,
                  "weight_decay": 1e-2, "grad_clip_norm": 0.5,
                  "embedding_optimizer": "rowwise_adagrad", "exact_dedup": True},
        "ema": {"enabled": True, "decay": 0.9},
    })


def labelled_batch(d, seed, n_valid=None):
    b = make_batch(d, B=8, seed=seed)
    b["y"] = (np.arange(8) % 3 == 0).astype(np.float32)
    if n_valid is not None:
        b["valid"] = (np.arange(8) < n_valid).astype(np.float32)
    return b


def test_train_step_matches_jax():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu.train.loss import bce_wll_style as jax_bce
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict, load_flax_train_state
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.loss import bce_wll_style

    d = train_cfg_dict()
    dims = dims_for(d)
    batches = [labelled_batch(d, 11), labelled_batch(d, 12, n_valid=6)]

    # ---- the JAX side ----
    jcfg = JConfig.from_dict(copy.deepcopy(d))
    init = {k: v for k, v in batches[0].items() if k != "y"}
    jmodel, variables = jax_model_and_variables(d, init)
    jtx, jsched = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
    jstate, jmask = jtrainer.make_train_state(jcfg, variables, jtx)
    jstep = jtrainer.make_train_step(jmodel, jtx, jcfg, jax.random.PRNGKey(1), ema_mask=jmask,
                                     schedule=jsched)
    jeval = jtrainer.make_eval_step(jmodel)
    programs = {}

    def jax_step(jstate, batch):
        """``jstep`` compiled once a batch layout (``compiled``; the two
        batches differ by their ``valid`` mask)."""
        key = tuple(sorted(batch))
        if key not in programs:
            programs[key] = compiled(jstep, jstate, batch)
        return programs[key](jstate, batch)

    def jax_loss_and_grads(params, batch):
        """``loss_and_grads`` compiled once a batch layout (``compiled``)."""
        key = ("grads",) + tuple(sorted(batch))
        if key not in programs:
            programs[key] = compiled(jax.jit(loss_and_grads), params, batch)
        return programs[key](params, batch)

    def loss_and_grads(params, batch):
        rest, tables = jtrainer.extract_tables(params)
        B, K, D = batch["seq"].shape[0], 8, d["model"]["emb_dim"]
        perts0 = {"dare": {"table_rows": jnp.zeros((B, K, 2 * D), jnp.float32)}}

        def loss_fn(rest_params, perts):
            full = jtrainer.insert_tables(rest_params, tables)
            (z, _, aux), _ = jmodel.apply({**full, "perturbations": perts}, batch,
                                          deterministic=True, mutable=["intermediates"])
            valid = batch.get("valid")
            return (jax_bce(z, batch["y"], valid=valid)
                    + AUX_W * jax_bce(aux, batch["y"], valid=valid))

        loss, (g_rest, g_perts) = jax.value_and_grad(loss_fn, argnums=(0, 1))(rest, perts0)
        return loss, g_rest, g_perts["dare"]["table_rows"]

    # ---- the port, from the same state ----
    cfg = Config.from_dict(copy.deepcopy(d))
    model = trainer.build_model(cfg, dims, device="cpu")
    tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
    state = trainer.make_train_state(cfg, model, tx)
    load_flax_train_state(state, jax.device_get(jstate))
    step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)

    def port_loss_and_grads(batch):
        taps = {}
        for p in model.parameters():
            p.grad = None
        z, _, aux = model(torch_batch(batch), taps=taps)
        y, valid = torch.from_numpy(batch["y"]), batch.get("valid")
        valid = None if valid is None else torch.from_numpy(valid)
        loss = bce_wll_style(z, y, valid) + AUX_W * bce_wll_style(aux, y, valid)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        selected.append(taps["sel_ids"].reshape(-1))
        return float(loss.detach()), grads, taps["table_rows"].grad

    def rel_close(name, got, want, rel):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        top = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= rel * max(top, 1e-30), f"{name}: err {err} > {rel} x {top}"

    jgrads_by_step = []
    selected = []

    def loss_and_grads_match(batch):
        jloss, jg_rest, jg_rows = jax_loss_and_grads(jstate.params, batch)
        loss, grads, g_rows = port_loss_and_grads(batch)
        rel_close("loss", loss, float(jloss), 1e-4)
        jg = flax_to_state_dict(jax.device_get(jg_rest))
        jgrads_by_step.append(jg)
        assert set(jg) == set(grads) == set(trainer.dense_params(model)), \
            sorted(set(jg) ^ set(grads))
        for n, g in grads.items():
            rel_close(f"grad {n}", g.numpy(), jg[n].numpy(), 1e-4)
        rel_close("grad table_rows", g_rows.numpy(), np.asarray(jg_rows), 1e-4)

    def states_match(n_steps):
        params = dict(model.named_parameters())
        jparams = flax_to_state_dict(jax.device_get(jstate.params))
        assert state.step == int(jstate.step) == n_steps
        for n, p in params.items():
            got, want = p.detach().numpy(), jparams[n].numpy()
            if n == trainer.SEQ_TABLE:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=n)
                continue
            big = np.ones(got.shape, bool)
            for jg in jgrads_by_step:
                g = np.abs(jg[n].numpy())
                big &= g > 1e-3 * g.max()
            np.testing.assert_allclose(got[big], want[big], rtol=1e-5, atol=1e-6, err_msg=n)
            assert np.abs(got - want).max() <= 2 * LR * n_steps + 1e-6, n
        np.testing.assert_allclose(
            state.table_opt["emb_tables"].accum.numpy(),
            np.asarray(jstate.table_opt["emb_tables"].accum), rtol=1e-5, atol=1e-12)
        jshadow = flax_to_state_dict(jax.device_get(jstate.ema.shadow))
        assert set(state.ema.shadow) == set(params) - {trainer.SEQ_TABLE}
        for n, s in state.ema.shadow.items():
            assert np.abs(s.numpy() - jshadow[n].numpy()).max() <= 2 * LR * n_steps + 1e-6, n
        assert state.ema.num_updates == int(jstate.ema.num_updates)

    def eval_matches(batch):
        params = {n: p.to(model.dare.emb_tables.device)
                  for n, p in flax_to_state_dict(jax.device_get(jstate.params)).items()}
        z, p = trainer.make_eval_step(model)(params, torch_batch(batch))
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        jz, jp = compiled(jeval, jstate.params, jb)(jstate.params, jb)
        rel_close("eval logits", z.numpy(), np.asarray(jz), 1e-4)
        rel_close("eval probabilities", p.numpy(), np.asarray(jp), 1e-4)

    def only_selected_rows_changed(table0):
        changed = set(torch.nonzero((model.dare.emb_tables != table0).any(dim=1))[:, 0].tolist())
        pad = jcfg.sequence.pad_id
        touched = set(torch.cat(selected).tolist()) - {pad}
        assert changed and changed <= touched, sorted(changed - touched)
        assert pad not in changed

    checks = Checks()
    with torch_threads():
        table0 = model.dare.emb_tables.detach().clone()
        for i, batch in enumerate(batches):
            checks.run(f"step {i + 1}: loss and gradients", loss_and_grads_match, batch)
            jstate, jloss = jax_step(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
            state, loss = step(state, torch_batch(batch))
            checks.run(f"step {i + 1}: loss", rel_close, "loss", float(loss), float(jloss), 1e-4)
            checks.run(f"after step {i + 1}: state", states_match, i + 1)
        checks.run("only selected rows changed, never the pad row", only_selected_rows_changed,
                   table0)
        checks.run("eval step", eval_matches, batches[0])
    checks.done()
