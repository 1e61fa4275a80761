"""The port's optional losses (``loss.apply_extra_losses``) against the JAX
package's ``train/loss.py`` and its train step.

* ``pairwise_auc_loss`` with ``hard_frac = 1.0`` (every negative a hard
  one, no random draw) and ``logit_l2``, with and without a ``valid``
  mask, on seeded batches that include one without positives, one without
  negatives and one whose only negatives are padded: within 1e-6 of
  JAX's (fp32; the same sums in another order).
* With random draws (``hard_frac`` 0 and 0.5) the port's generator cannot
  give ``jax.random.categorical``'s draws: its loss for four seeds lies
  within the range JAX's takes over 256 keys on the same batch, and
  ``draw_negatives`` never picks a positive or a padded row.
* Two sparse-table train steps (the tiny model without the encoder, fp32,
  every dropout off) with ``lambda_rank`` (hard negatives only) and
  ``lambda_logit_l2`` on, the second batch partial, so the masked
  ``logit_l2`` of the JAX step runs: the loss within 1e-5 relative, the
  table within 1e-5 relative (1e-6 absolute), the accumulator within
  1e-5 relative, the dense parameters within 1e-5 relative where the
  gradient exceeds 1e-3 of its tensor's largest magnitude and elsewhere
  within the 2 lr x steps an Adam sign flip allows (the bands of
  ``test_torch_train_step.py``).

One test item (see ``_torch_helpers``).
"""

import copy

import numpy as np

from _torch_helpers import Checks, compiled, dims_for, flax_variables_from_port, make_batch
from _torch_helpers import SMALL_QNN, tiny_cfg_dict, torch_batch, torch_threads

LR = 1e-2
B, R = 64, 8


def loss_batches():
    """(z, y, valid) triples of B rows."""
    rng = np.random.default_rng(9)
    out = []
    for case in ("mixed", "no positives", "no negatives", "negatives padded"):
        z = rng.normal(0, 2, B).astype(np.float32)
        y = (rng.random(B) < 0.3).astype(np.float32)
        valid = (rng.random(B) < 0.8).astype(np.float32)
        if case == "no positives":
            y[:] = 0
        elif case == "no negatives":
            y[:] = 1
        elif case == "negatives padded":
            valid = y.copy()
        out.append((case, z, y, valid))
    return out


def step_cfg_dict():
    return tiny_cfg_dict(amp="none", **{
        "sequence": {"transformer_block": False},
        "model": {"dare_dropout": 0.0, "embedding_dropout": 0.0, "qnn_alpha": SMALL_QNN},
        "train": {"batch_size": 8, "epochs": 2, "warmup_epochs": 1, "lr": LR,
                  "weight_decay": 1e-2, "grad_clip_norm": 0.5,
                  "embedding_optimizer": "rowwise_adagrad", "exact_dedup": False},
        "loss": {"apply_extra_losses": True, "lambda_rank": 0.5, "lambda_logit_l2": 0.1,
                 "num_neg_per_pos": 4, "hard_neg_frac": 1.0},
        "ema": {"enabled": False},
    })


def test_extra_losses_match_jax():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.train import loss as jloss
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict, load_flax_train_state
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train import loss as tloss
    from tossctr_tpu_torch.train import trainer

    def t(a):
        return torch.from_numpy(np.asarray(a))

    @jax.jit
    def jax_losses(z, y, valid):
        key = jax.random.PRNGKey(0)
        return (jloss.pairwise_auc_loss(z, y, key, num_neg_per_pos=R, hard_frac=1.0),
                jloss.pairwise_auc_loss(z, y, key, num_neg_per_pos=R, hard_frac=1.0,
                                        valid=valid),
                jloss.logit_l2(z))

    def hard_negatives_and_l2(case, z, y, valid):
        want = [float(x) for x in jax_losses(z, y, valid)]
        gen = torch.Generator().manual_seed(0)
        got = [float(tloss.pairwise_auc_loss(t(z), t(y), gen, num_neg_per_pos=R, hard_frac=1.0)),
               float(tloss.pairwise_auc_loss(t(z), t(y), gen, num_neg_per_pos=R, hard_frac=1.0,
                                             valid=t(valid))),
               float(tloss.logit_l2(t(z)))]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=case)

    @jax.jit
    def jax_draws(z, y, valid, keys):
        def one(key, frac):
            return jloss.pairwise_auc_loss(z, y, key, num_neg_per_pos=R, hard_frac=frac,
                                           valid=valid)

        return (jax.vmap(lambda k: one(k, 0.0))(keys), jax.vmap(lambda k: one(k, 0.5))(keys))

    def random_draws_in_range(case, z, y, valid):
        keys = jax.random.split(jax.random.PRNGKey(1), 256)
        ranges = [np.asarray(x) for x in jax_draws(z, y, valid, keys)]
        for frac, want in zip((0.0, 0.5), ranges):
            for seed in range(4):
                gen = torch.Generator().manual_seed(seed)
                got = float(tloss.pairwise_auc_loss(t(z), t(y), gen, num_neg_per_pos=R,
                                                    hard_frac=frac, valid=t(valid)))
                assert want.min() - 1e-6 <= got <= want.max() + 1e-6, (case, frac, got,
                                                                        want.min(), want.max())
        neg = (y < 0.5) & (valid > 0)
        idx = tloss.draw_negatives(t(neg), (B, 4 * R), torch.Generator().manual_seed(3))
        if neg.any():
            assert neg[idx.numpy()].all(), f"{case}: a draw picked a positive or a padded row"
            # 2048 draws reach every one of the (at most 64) negatives
            assert set(np.unique(idx.numpy())) == set(np.flatnonzero(neg)), case
        else:
            assert not neg[idx.numpy()].any()

    def two_steps():
        d = step_cfg_dict()
        dims = dims_for(d)
        bs = []
        for seed, n_valid in ((41, 8), (42, 5)):
            b = make_batch(d, B=8, seed=seed)
            b["y"] = (np.arange(8) % 3 == seed % 3).astype(np.float32)
            b["valid"] = (np.arange(8) < n_valid).astype(np.float32)
            bs.append(b)
        jcfg = JConfig.from_dict(copy.deepcopy(d))
        jmodel = jtrainer.build_model(jcfg, dims)
        cfg = Config.from_dict(copy.deepcopy(d))
        model = init_params(trainer.build_model(cfg, dims, device="cpu"), seed=4)
        variables = flax_variables_from_port(
            model, jmodel, {k: v for k, v in bs[0].items() if k not in ("y", "valid")})
        jtx, jsched = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
        jstate, jmask = jtrainer.make_train_state(jcfg, variables, jtx)
        jstep = jtrainer.make_train_step(jmodel, jtx, jcfg, jax.random.PRNGKey(1),
                                         ema_mask=jmask, schedule=jsched)
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        state = trainer.make_train_state(cfg, model, tx)
        load_flax_train_state(state, jax.device_get(jstate))
        step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)
        jfn = None
        big = {}
        for i, b in enumerate(bs):
            jb = jax.tree_util.tree_map(jnp.asarray, b)
            jfn = jfn or compiled(jstep, jstate, jb)
            jstate, jl = jfn(jstate, jb)
            state, loss = step(state, torch_batch(b))
            n = i + 1
            assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)), (n, loss, jl)
            jparams = flax_to_state_dict(jax.device_get(jstate.params))
            for name, p in model.named_parameters():
                got, want = p.detach().numpy(), jparams[name].numpy()
                if name == trainer.SEQ_TABLE:
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
                    continue
                g = np.abs(p.grad.numpy())
                big[name] = big.get(name, True) & (g > 1e-3 * g.max())
                np.testing.assert_allclose(got[big[name]], want[big[name]], rtol=1e-5, atol=1e-6,
                                           err_msg=f"step {n} {name}")
                assert np.abs(got - want).max() <= 2 * LR * n + 1e-6, (n, name)
            np.testing.assert_allclose(state.table_opt["emb_tables"].accum.numpy(),
                                       np.asarray(jstate.table_opt["emb_tables"].accum),
                                       rtol=1e-5, atol=1e-12)

    checks = Checks()
    with torch_threads():
        for case, z, y, valid in loss_batches():
            checks.run(f"hard negatives and logit_l2, {case}", hard_negatives_and_l2, case, z, y,
                       valid)
            checks.run(f"random draws, {case}", random_draws_in_range, case, z, y, valid)
        checks.run("two train steps with the extra losses", two_steps)
    checks.done()
