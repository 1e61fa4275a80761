"""The port's dense-table train step (``train.embedding_optimizer: adamw |
adafactor | sgd``) against the JAX package's, and its Adafactor against
``optax.adafactor``.

* Two train steps on each side from the port's seeded parameters, for
  each optimizer with the lane-fused table and with the split ``emb_att``
  / ``emb_rep`` pair: the tiny model without the encoder (its paths have
  tests of their own), fp32, every dropout off, EMA on, ``grad_clip_norm``
  low enough that optax's global-norm clip fires on both steps (the
  clipped gradients' norm is the clip), the second batch partial (a
  ``valid`` mask).  The JAX side is the JAX package's dense step as its
  ``make_train_step`` composes it (its model's loss and gradients,
  ``make_optimizer``'s transform with optax's clip, ``apply_updates``,
  ``update_ema``, from ``make_train_state``'s state), the model's loss and
  gradient program and the EMA's compiled once a layout and shared by the
  three optimizers (their EMA settings and masks are the same), the
  optimizer's once a config.  ``adamw`` is one
  AdamW over every parameter; ``adafactor`` / ``sgd`` take the parameters
  whose flax path holds a table marker (the sequence tables and the
  categorical ``table_{d}``) and AdamW the rest.  Held after each step:
  the loss within 1e-5 relative; every parameter and its EMA shadow within
  1e-5 relative (1e-6 absolute) where every step's gradient exceeds 1e-3
  of its tensor's largest magnitude, elsewhere within 2 lr x steps x
  max(1, the tensor's RMS): Adam's and Adafactor's first steps move an
  element by about lr x sign(g) (Adafactor's times the tensor's RMS), so a
  near-zero gradient whose sign rounds the other way moves it the other
  way; AdamW's moments and Adafactor's second moments within 1e-4
  relative (1e-9 absolute) of each tensor's largest; the step counts.
* ``Adafactor`` alone against ``optax.adafactor`` at its defaults over
  three steps of seeded gradients on a schedule: tensors factored over
  their two largest dimensions ((300, 130), (128, 256), (3, 200, 150)), a
  (V, 64) table that is not (its second largest dimension is below 128),
  a (64, 2) table and a vector: parameters within 1e-5 relative of each
  tensor's largest magnitude, the second moments within 1e-5 relative.
* The dense-mode state saves and loads (``save_train_state`` /
  ``load_train_state``), Adafactor's factored rows and columns included.

One test item (see ``_torch_helpers``).
"""

import copy

import numpy as np

from _torch_helpers import Checks, compiled, dims_for, flax_variables_from_port, make_batch
from _torch_helpers import SMALL_QNN, tiny_cfg_dict, torch_batch, torch_threads

LR = 1e-2
CLIP = 0.05  # below every step's gradient norm here: the clip fires


def dense_cfg_dict(opt: str, fused: bool) -> dict:
    return tiny_cfg_dict(amp="none", **{
        "sequence": {"transformer_block": False},
        "model": {"fused_seq_tables": fused, "dare_dropout": 0.0, "embedding_dropout": 0.0,
                  "qnn_alpha": SMALL_QNN},
        "train": {"batch_size": 8, "epochs": 2, "warmup_epochs": 1, "lr": LR,
                  "weight_decay": 1e-2, "grad_clip_norm": CLIP, "embedding_optimizer": opt},
        "ema": {"enabled": True, "decay": 0.9},
    })


def batches(d):
    out = []
    for seed, n_valid in ((31, 8), (32, 5)):
        b = make_batch(d, B=8, seed=seed)
        b["y"] = (np.arange(8) % 3 == (seed % 3)).astype(np.float32)
        b["valid"] = (np.arange(8) < n_valid).astype(np.float32)
        out.append(b)
    return out


def test_dense_table_steps_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.train import ema as jema
    from tossctr_tpu.train import loss as jloss
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.adafactor import Adafactor, factored_dims
    from tossctr_tpu_torch.train.checkpoint import load_train_state, save_train_state

    def close(name, got, want, rel, floor=0.0):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        assert err <= rel * float(np.abs(want).max(initial=0.0)) + floor, f"{name}: {err}"

    programs = {}

    def jax_side(d, model):
        """The JAX package's dense step for ``d`` (``make_train_step``'s dense
        branch: value_and_grad of the loss, the transform, apply_updates,
        the EMA) and its state, from the port model's parameters."""
        fused = d["model"]["fused_seq_tables"]
        jcfg = JConfig.from_dict(copy.deepcopy(d))
        if fused not in programs:  # the model, its loss and gradients: one a layout
            jmodel = jtrainer.build_model(jcfg, dims_for(d))
            aux_w = float(jcfg.model.qnn_alpha.aux_head_weight)

            def loss_fn(params, b):
                z, _, aux = jmodel.apply(params, b, deterministic=True)
                return (jloss.bce_wll_style(z, b["y"], valid=b["valid"])
                        + aux_w * jloss.bce_wll_style(aux, b["y"], valid=b["valid"]))

            programs[fused] = (jmodel, jax.jit(jax.value_and_grad(loss_fn)), {})
        jmodel, loss_and_grads, shared = programs[fused]
        b0 = {k: v for k, v in batches(d)[0].items() if k not in ("y", "valid")}
        variables = jax.tree_util.tree_map(jnp.asarray,
                                           flax_variables_from_port(model, jmodel, b0))
        jtx, _ = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
        jstate, jmask = jtrainer.make_train_state(jcfg, variables, jtx)
        e = jcfg.ema

        @jax.jit
        def apply(grads, state):
            updates, opt_state = jtx.update(grads, state.opt_state, state.params)
            return optax.apply_updates(state.params, updates), opt_state

        @jax.jit
        def ema_update(ema, params, step):
            return jema.update_ema(ema, params, step, base_decay=float(e.decay),
                                   warmup_steps=int(e.warmup_steps),
                                   warmup_type=str(e.warmup_type),
                                   update_after_step=int(e.update_after_step),
                                   update_interval=int(e.update_interval), mask=jmask)

        fns = {}

        def jstep(state, b):
            # compiled without LLVM's optimisations: the loss and gradients and
            # the EMA once a layout (the three optimizers share them: the same
            # model, the same EMA), the optimizer once a config
            if "grads" not in shared:
                shared["grads"] = compiled(loss_and_grads, state.params, b)
            loss, grads = shared["grads"](state.params, b)
            if not fns:
                fns["apply"] = compiled(apply, grads, state)
            params, opt_state = fns["apply"](grads, state)
            step = state.step + 1
            if "ema" not in shared:
                shared["ema"] = compiled(ema_update, state.ema, params, step)
            ema = shared["ema"](state.ema, params, step)
            return jtrainer.TrainState(params, opt_state, ema, step, None), loss

        return jstate, jstep

    def two_steps(opt, fused):
        d = dense_cfg_dict(opt, fused)
        dims = dims_for(d)
        cfg = Config.from_dict(copy.deepcopy(d))
        model = init_params(trainer.build_model(cfg, dims, device="cpu"), seed=5)
        jstate, jstep = jax_side(d, model)
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        state = trainer.make_train_state(cfg, model, tx)
        step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)
        names = dict(model.named_parameters())
        tables = {n for n in names if trainer.is_embedding_param(n)}
        assert {"cat_embed.table_4", "cat_embed.table_8", "cat_embed.table_16"} <= tables
        assert ({"dare.emb_tables"} if fused else {"dare.emb_att", "dare.emb_rep"}) <= tables
        assert all(p.requires_grad for p in names.values())
        if opt == "adafactor":
            assert set(state.emb_opt.params) == tables
        big = {n: np.ones(p.shape, bool) for n, p in names.items()}
        for i, b in enumerate(batches(d)):
            jstate, jloss = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
            state, loss = step(state, torch_batch(b))
            n_steps = i + 1
            close(f"step {n_steps} loss", float(loss), float(jloss), 1e-5)
            grads = {n: p.grad.numpy() for n, p in names.items()}
            gn = float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                                   for g in grads.values())))
            assert abs(gn - CLIP) <= 1e-4 * CLIP, f"step {n_steps}: clipped norm {gn}"
            jparams = flax_to_state_dict(jax.device_get(jstate.params))
            jshadow = flax_to_state_dict(jax.device_get(jstate.ema.shadow))
            assert set(state.ema.shadow) == set(names)  # dense mode: the tables too
            for n, p in names.items():
                g = np.abs(grads[n])
                big[n] &= g > 1e-3 * g.max()
                got, want = p.detach().numpy(), jparams[n].numpy()
                band = 2 * LR * n_steps * max(1.0, float(np.sqrt(np.mean(want ** 2))))
                for tag, a, w in ((n, got, want),
                                  (f"ema {n}", state.ema.shadow[n].numpy(), jshadow[n].numpy())):
                    np.testing.assert_allclose(a[big[n]], w[big[n]], rtol=1e-5, atol=1e-6,
                                               err_msg=f"step {n_steps} {tag}")
                    assert np.abs(a - w).max() <= band + 1e-6, f"step {n_steps} {tag}"
            assert state.step == int(jstate.step) == n_steps
            assert state.ema.num_updates == int(jstate.ema.num_updates)
            adam = next(s for s in jax.tree_util.tree_leaves(
                jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
            mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
            by_param = {id(p): n for n, p in names.items()}
            held = set()
            for p, st in state.opt.state.items():
                n = by_param[id(p)]
                held.add(n)
                close(f"step {n_steps} exp_avg {n}", st["exp_avg"].numpy(), mu[n].numpy(), 1e-4,
                      1e-9)
                close(f"step {n_steps} exp_avg_sq {n}", st["exp_avg_sq"].numpy(),
                      nu[n].numpy(), 1e-4, 1e-12)
            assert held == (set(names) if opt == "adamw" else set(names) - tables)
            if opt == "adafactor":
                fs = next(s for s in jax.tree_util.tree_leaves(
                    jstate.opt_state, is_leaf=lambda x: hasattr(x, "v_row"))
                    if hasattr(s, "v_row"))
                assert state.emb_opt.count == int(fs.count) == n_steps
                for key in ("v_row", "v_col", "v"):
                    want = flax_to_state_dict(getattr(fs, key))
                    for n in tables:
                        close(f"step {n_steps} {key} {n}", getattr(state.emb_opt, key)[n].numpy(),
                              want[n].numpy(), 1e-4, 1e-12)
        if opt == "adafactor":  # the dense-mode state saves and loads
            path = str(tmp_path / f"state_{fused}.pt")
            save_train_state(path, state, epoch=1)
            fresh = trainer.make_train_state(cfg, trainer.build_model(cfg, dims, device="cpu"),
                                             tx)
            assert load_train_state(path, fresh) == {"epoch": 1}
            assert fresh.emb_opt.count == state.emb_opt.count and fresh.step == state.step
            for key in ("v_row", "v_col", "v"):
                for n, t in getattr(state.emb_opt, key).items():
                    assert torch.equal(getattr(fresh.emb_opt, key)[n], t), (key, n)
            a, b = fresh.opt.state_dict()["state"], state.opt.state_dict()["state"]
            assert all(torch.equal(a[k]["exp_avg_sq"], b[k]["exp_avg_sq"]) for k in b)

    def adafactor_matches_optax():
        shapes = {"a": (300, 130), "b": (128, 256), "c": (3, 200, 150), "table": (500, 64),
                  "pair": (64, 2), "vec": (64,)}
        assert factored_dims(shapes["a"]) == (1, 0) and factored_dims(shapes["b"]) == (0, 1)
        assert factored_dims(shapes["table"]) is None and factored_dims((10_000, 128)) == (1, 0)
        rng = np.random.default_rng(5)
        params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        params["vec"] *= 1e-4  # a block RMS below optax's 1e-3 floor

        def sched(count):
            return 0.01 * (count + 1) / 3

        tx = optax.adafactor(sched)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        jopt = jax.jit(tx.init)(jp)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        af = Adafactor(tp)

        @jax.jit
        def update(g, opt_state, p):
            u, opt_state = tx.update(g, opt_state, p)
            return optax.apply_updates(p, u), opt_state

        for i in range(3):
            grads = {k: rng.normal(0, 1e-3 if k == "pair" else 1, s).astype(np.float32)
                     for k, s in shapes.items()}
            grads["table"][::3] = 0.0  # rows that get no gradient
            jp, jopt = update({k: jnp.asarray(g) for k, g in grads.items()}, jopt, jp)
            for k, t in tp.items():
                t.grad = torch.from_numpy(grads[k])
            af.step(sched(i))
            for k in shapes:
                close(f"adafactor step {i + 1} {k}", tp[k].numpy(), np.asarray(jp[k]), 1e-5)
            fs = jopt[0]
            for key in ("v_row", "v_col", "v"):
                for k in shapes:
                    close(f"adafactor step {i + 1} {key} {k}", getattr(af, key)[k].numpy(),
                          np.asarray(getattr(fs, key)[k]), 1e-5, 1e-30)

    checks = Checks()
    with torch_threads():
        checks.run("adafactor against optax.adafactor", adafactor_matches_optax)
        for opt in ("adamw", "adafactor", "sgd"):
            for fused in (True, False):
                checks.run(f"{opt}, {'fused' if fused else 'split'} tables: two steps",
                           two_steps, opt, fused)
    checks.done()
