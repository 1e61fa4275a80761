"""The port's training pieces against the JAX package's (or optax's)
functions on the same numpy inputs, fp32 to 1e-6 of each output's largest
magnitude unless stated:

* ``bce_wll_style`` with and without ``valid``, and with a class absent;
* ``make_lr_schedule`` (warmup + cosine, and warmup + constant);
* the EMA: ``decay_at`` (linear / cosine / none), ``update_ema`` with its
  step gates, ``ema_params``;
* ``dedup_rows`` (unique ids bit-equal, gradient sums) and the exact
  row-wise AdaGrad update with ``halves = 2``, a pad row, duplicates and
  weight decay, on an fp32 and a bf16 table (bf16: equal after rounding,
  up to one bf16 ulp where the fp32 update lands on a rounding boundary);
* torch's AdamW, as the trainer configures it, against ``optax.adamw``
  over three steps of a changing learning rate;
* the training ``BatchIterator``: per-epoch permutation and the padded
  last batch with ``valid``, as the JAX loader yields them.

One test item (see ``_torch_helpers``).
"""

import numpy as np

from _torch_helpers import Checks, torch_threads

REL = 1e-6


def _close(name, got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * max(top, 1e-30), f"{name}: err {err} > {rel} x {top}"


def test_train_parts_match_jax(tmp_path):
    import jax.numpy as jnp
    import optax
    import torch

    from tossctr_tpu.data.dataset import ShardCache as JShardCache
    from tossctr_tpu.data.loader import BatchIterator as JBatchIterator
    from tossctr_tpu.train import ema as jema
    from tossctr_tpu.train import sparse_embed as jse
    from tossctr_tpu.train.loss import bce_wll_style as jax_bce
    from tossctr_tpu.train.sched import make_lr_schedule as jax_schedule
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.train import ema, sparse_embed, trainer
    from tossctr_tpu_torch.train.loss import bce_wll_style
    from tossctr_tpu_torch.train.sched import make_lr_schedule

    rng = np.random.default_rng(0)
    t = torch.from_numpy

    def loss(valid, labels):
        z = rng.normal(0, 3, 64).astype(np.float32)
        y = labels.astype(np.float32)
        v = None if valid is None else valid.astype(np.float32)
        want = jax_bce(jnp.asarray(z), jnp.asarray(y), None if v is None else jnp.asarray(v))
        got = bce_wll_style(t(z), t(y), None if v is None else t(v))
        _close("loss", float(got), float(want))

    def schedule(cosine):
        want = jax_schedule(3e-4, warmup_steps=7, total_steps=40, cosine=cosine)
        got = make_lr_schedule(3e-4, warmup_steps=7, total_steps=40, cosine=cosine)
        for s in range(45):
            _close(f"lr at step {s}", got(s), float(want(s)))

    def ema_decay(kind):
        for n in (0, 1, 5, 19, 100):
            _close(f"decay {kind} n={n}", ema.decay_at(n, 0.999, 20, kind),
                   float(jema.decay_at(jnp.int32(n), 0.999, 20, kind)))

    def ema_update():
        names = ("a.kernel", "a.bias", "dare.emb_tables")
        params = [{n: rng.normal(0, 1, (3, 4)).astype(np.float32) for n in names}
                  for _ in range(6)]
        tree = lambda p: {"a": {"kernel": p[names[0]], "bias": p[names[1]]},  # noqa: E731
                          "dare": {"emb_tables": p[names[2]]}}
        jmask = jema.make_ema_mask(tree(params[0]), ["emb_tables"])
        mask = ema.make_ema_mask(names, ["emb_tables"])
        assert mask == {"a.kernel": True, "a.bias": True, "dare.emb_tables": False}
        js = jema.init_ema(tree(params[0]), jmask)
        ps = ema.init_ema({n: t(v) for n, v in params[0].items()}, mask)
        kw = dict(base_decay=0.9, warmup_steps=3, warmup_type="linear", update_after_step=2,
                  update_interval=2)
        for step in range(1, 6):
            js = jema.update_ema(js, tree(params[step]), jnp.int32(step), mask=jmask, **kw)
            ps = ema.update_ema(ps, {n: t(v) for n, v in params[step].items()}, step, **kw)
            assert ps.num_updates == int(js.num_updates)
            _close(f"shadow kernel step {step}", ps.shadow["a.kernel"], js.shadow["a"]["kernel"])
            _close(f"shadow bias step {step}", ps.shadow["a.bias"], js.shadow["a"]["bias"])
        assert "dare.emb_tables" not in ps.shadow
        live = {n: t(v) for n, v in params[5].items()}
        out = ema.ema_params(ps, live)
        assert out["dare.emb_tables"] is live["dare.emb_tables"]
        _close("ema_params", out["a.kernel"], ps.shadow["a.kernel"])

    def ids_and_grads(V=40, N=96, W=16):
        ids = rng.integers(0, V, N).astype(np.int32)
        ids[::7] = 0  # pad-row occurrences
        ids[1::5] = ids[2]  # a row many times
        return ids, rng.normal(0, 1, (N, W)).astype(np.float32)

    def dedup():
        ids, g = ids_and_grads()
        ju, jg = jse.dedup_rows(jnp.asarray(ids), jnp.asarray(g), drop_index=40)
        u, gu, n_unique = sparse_embed.dedup_rows(t(ids), t(g), drop_index=40)
        n = int(n_unique)
        assert n == len(np.unique(ids))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        _close("segment sums", gu.numpy()[:n], np.asarray(jg)[:n])
        assert not gu[n:].any()

    def adagrad(table_dtype):
        V, W = 40, 16
        ids, g = ids_and_grads(V, W=W)
        table = rng.normal(0, 1, (V, W)).astype(np.float32)
        accum = rng.uniform(0, 2, (V, 2)).astype(np.float32)
        jdt = jnp.bfloat16 if table_dtype == "bf16" else jnp.float32
        tdt = torch.bfloat16 if table_dtype == "bf16" else torch.float32
        jt, jst = jse.rowwise_adagrad_update(
            jnp.asarray(table, jdt), jse.RowwiseAdagradState(jnp.asarray(accum)),
            jnp.asarray(ids), jnp.asarray(g), lr=jnp.float32(0.05), weight_decay=0.01,
            pad_row=0, exact_dedup=True, halves=2)
        tt = t(table).to(tdt)
        st = sparse_embed.RowwiseAdagradState(t(accum.copy()))
        sparse_embed.rowwise_adagrad_update(tt, st, t(ids), t(g), lr=0.05, weight_decay=0.01,
                                            pad_row=0)
        _close("accum", st.accum.numpy(), np.asarray(jst.accum))
        want = np.asarray(jt.astype(jnp.float32))
        got = tt.float().numpy()
        if table_dtype == "bf16":
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all()
            assert (got == want).mean() > 0.99
        else:
            _close("table", got, want)
        assert (got[0] == np.asarray(jnp.asarray(table, jdt).astype(jnp.float32))[0]).all()
        untouched = np.setdiff1d(np.arange(V), ids)
        np.testing.assert_array_equal(st.accum.numpy()[untouched], accum[untouched])

    def adamw():
        shapes = {"w": (5, 7), "b": (7,)}
        params = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
        lrs = [1e-3, 3e-3, 2e-3]
        tx = optax.adamw(lambda c: jnp.asarray(lrs)[c], b1=0.9, b2=0.999, eps=1e-8,
                         weight_decay=0.01)
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        js = tx.init(jp)
        tp = {n: torch.nn.Parameter(t(v.copy())) for n, v in params.items()}
        tx_args, _ = trainer.make_optimizer(
            Config.from_dict({"train": {"lr": lrs[0], "weight_decay": 0.01}}), 10)
        opt = torch.optim.AdamW(list(tp.values()), **tx_args)
        for lr in lrs:
            grads = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
            upd, js = tx.update({n: jnp.asarray(v) for n, v in grads.items()}, js, jp)
            jp = optax.apply_updates(jp, upd)
            for n, p in tp.items():
                p.grad = t(grads[n])
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            for n in shapes:
                _close(f"adamw {n} lr={lr}", tp[n].detach().numpy(), np.asarray(jp[n]))

    def batches():
        man = write_synth_cache(str(tmp_path / "cache"), 23, num_dim=3, cat_cols=["a", "b"],
                                cat_cards=[5, 7], seq_len=6, seq_vocab=50, shard_rows=10,
                                seed=1)
        kw = dict(batch_size=8, train=True, shuffle=True, seed=5, drop_last=False)
        mine, theirs = BatchIterator(ShardCache(man), **kw), JBatchIterator(JShardCache(man), **kw)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(mine), list(theirs)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert set(a) == set(b), (sorted(a), sorted(b))
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert got[-1]["valid"].sum() == 23 - 16

    checks = Checks()
    with torch_threads():
        labels = rng.random(64) < 0.3
        checks.run("loss", loss, None, labels)
        checks.run("loss with valid", loss, rng.random(64) < 0.8, labels)
        checks.run("loss with no positives", loss, None, np.zeros(64, bool))
        checks.run("schedule cosine", schedule, True)
        checks.run("schedule constant", schedule, False)
        for kind in ("linear", "cosine", "none"):
            checks.run(f"ema decay {kind}", ema_decay, kind)
        checks.run("ema update", ema_update)
        checks.run("dedup_rows", dedup)
        checks.run("rowwise adagrad fp32 table", adagrad, "f32")
        checks.run("rowwise adagrad bf16 table", adagrad, "bf16")
        checks.run("adamw", adamw)
        checks.run("training batches", batches)
    checks.done()
