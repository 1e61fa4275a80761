"""The port's streaming and proxy DARE selection against the JAX package.

* Streaming (``select_chunk`` < L, with phantom positions when the chunk
  does not divide L): the ids are bit-equal to the port's dense pass in
  fp32 for five (top_k, chunk) pairs (every pass scores with one op form,
  and the merges are stable; the dense pass is bit-equal to JAX's in
  ``test_torch_select.py``), and to JAX's
  ``dare_select_ids(select_chunk=...)`` for one.
* Proxy at block 1 (the proxy is the att table): bit-equal to the dense
  pass, as ``tests/test_select_proxy.py`` holds the JAX package.
* Proxy at block > 1 against JAX's ``_proxy_topk_ids``: the ids are equal
  on every row whose stage-1 gap (the proxy scores either side of the
  candidates' cut) and stage-2 gap (the exact scores either side of place
  K) exceed 1e-5; the fp32 block means may sum in another order, so a
  closer row could part.  The seeded batch has 0 such other rows, which
  the check asserts, so every row is held.  The fused table's att half
  (a strided view) gives the same ids as the att table alone.
* The model forward within 1e-4 in fp32 in both modes, and one sparse
  step with ``select_proxy``: its loss and gradients (the dense
  parameters' and the gathered table rows') within 1e-4 of each tensor's
  largest magnitude of the JAX sparse step's, then the port's whole step
  (its loss, and only selected rows moved), on the model without its
  encoder.  The forwards run the encoder's plain paths on both sides (the
  kernels have their own tests; selection is what differs here, and the
  whole step's arithmetic is held by ``test_torch_train_step.py``).

Tiny shapes: the JAX package's own proxy test peaks at 11-23 GB.  One
test item (see ``_torch_helpers``).
"""

import copy

import numpy as np

import _torch_helpers as H

LR = 1e-2
PROXY = {"select_proxy": True, "select_proxy_block": 4, "select_proxy_candidates": 12}
CHUNK = {"select_chunk": 10}  # L = 24: three chunks, six phantom positions


def _ids_case(seed=0, V=256, D=16, B=16, L=40, pads=True):
    rng = np.random.default_rng(seed)
    att = rng.normal(0, 1, (V, D)).astype(np.float32)
    seq = rng.integers(1, V, (B, L)).astype(np.int32)
    q = rng.normal(0, 1, (B, D)).astype(np.float32)
    if pads:
        seq[0, :-2] = 0  # fewer real tokens than K
        seq[1, :] = 0
        seq[2, ::3] = 0
    return att, seq, q


def _cfg(encoder=True, **seq):
    return H.tiny_cfg_dict("none", **{
        "sequence": {**seq, "transformer_block": encoder,
                     "tfm": {"n_layers": 1, "mha_dropout": 0.0, "ffn_dropout": 0.0}},
        "model": {"use_pallas_attention": False, "use_pallas_ffn": False, "dare_dropout": 0.0,
                  "embedding_dropout": 0.0,
                  "qnn_alpha": {**H.SMALL_QNN, "aux_head_weight": 0.1}},
        "train": {"batch_size": 8, "epochs": 2, "warmup_epochs": 1, "lr": LR,
                  "weight_decay": 1e-2, "grad_clip_norm": 0.5,
                  "embedding_optimizer": "rowwise_adagrad", "exact_dedup": True},
        "ema": {"enabled": True, "decay": 0.9},
    })


def test_select_modes_match_jax():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.ops.topk_select import _proxy_topk_ids as jax_proxy
    from tossctr_tpu.ops.topk_select import dare_select_ids as jax_select
    from tossctr_tpu.ops.topk_select import recency_log_decay as jax_decay
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu.train.loss import bce_wll_style as jax_bce
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict
    from tossctr_tpu_torch.models.ctr_model import build_model, init_params
    from tossctr_tpu_torch.ops import dare_select_ids, recency_log_decay
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.loss import bce_wll_style

    def port_ids(att, seq, q, top_k, **mode):
        idx, ids, _ = dare_select_ids(torch.from_numpy(att), torch.from_numpy(seq),
                                      torch.from_numpy(q), top_k=top_k, tau=8.0, **mode)
        return idx.numpy(), ids.numpy()

    def streaming_bit_equal(top_k, chunk, against_jax):
        att, seq, q = _ids_case()
        got = port_ids(att, seq, q, top_k, select_chunk=chunk)
        for g, e in zip(got, port_ids(att, seq, q, top_k)):
            np.testing.assert_array_equal(g, e)
        if against_jax:
            want = jax.jit(jax_select, static_argnames=("top_k", "tau", "select_chunk"))(
                jnp.asarray(att), jnp.asarray(seq), jnp.asarray(q), top_k=top_k, tau=8.0,
                select_chunk=chunk)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))

    def proxy_block1_bit_equal(top_k, candidates):
        att, seq, q = _ids_case(1)
        got = port_ids(att, seq, q, top_k, select_proxy={"block": 1, "candidates": candidates})
        for g, e in zip(got, port_ids(att, seq, q, top_k)):
            np.testing.assert_array_equal(g, e)

    def proxy_matches_jax(top_k, block, candidates):
        att, seq, q = _ids_case(2, pads=False)
        seq[3, :5] = 0  # a few left pads, still more real tokens than candidates
        B, L = seq.shape
        log_decay = jax_decay(L, 8.0)
        want = jax.jit(jax_proxy, static_argnums=(4, 5, 6, 7, 8, 9))(
            jnp.asarray(att), jnp.asarray(seq), jnp.asarray(q), log_decay, 8.0, 0, top_k, block,
            candidates, lambda t, i: jnp.take(t, i, axis=0))
        got = port_ids(att, seq, q, top_k, select_proxy={"block": block,
                                                         "candidates": candidates})
        # the gaps at the two cuts, from the JAX package's scores
        dec = np.asarray(log_decay)
        proxy = att.reshape(-1, block, att.shape[1]).mean(axis=1)
        s1 = np.where(seq == 0, -1e9, (proxy[seq // block] * q[:, None]).sum(-1) + dec)
        cand = np.argsort(-s1, axis=1, kind="stable")[:, :candidates]
        s1s = -np.sort(-s1, axis=1)
        cids = np.take_along_axis(seq, cand, 1)
        s2 = np.where(cids == 0, -1e9, (att[cids] * q[:, None]).sum(-1) + dec[cand])
        s2s = -np.sort(-s2, axis=1)
        clear = ((s1s[:, candidates - 1] - s1s[:, candidates] > 1e-5)
                 & (s2s[:, top_k - 1] - s2s[:, top_k] > 1e-5))
        assert int((~clear).sum()) == 0, f"{int((~clear).sum())} rows within 1e-5 at a cut"
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[clear], np.asarray(w)[clear])
        # the fused (V, 2D) table's att half gives the same ids
        fused = torch.from_numpy(np.concatenate([att, -att], axis=1))
        idx, ids, _ = dare_select_ids(fused[:, :att.shape[1]], torch.from_numpy(seq),
                                      torch.from_numpy(q), top_k=top_k, tau=8.0,
                                      select_proxy={"block": block, "candidates": candidates})
        np.testing.assert_array_equal(idx.numpy(), got[0])
        np.testing.assert_array_equal(ids.numpy(), got[1])

    def decay_unchanged():
        np.testing.assert_array_max_ulp(recency_log_decay(24, 8.0).numpy(),
                                        np.asarray(jax_decay(24, 8.0)), maxulp=1)

    # one parameter draw for every mode (the parameters do not depend on
    # it): the port's seeded init, carried to flax without compiling its init
    d_proxy = _cfg(**PROXY)
    batch0 = H.make_batch(d_proxy, B=8, seed=1)
    variables = H.flax_variables_from_port(
        init_params(build_model(Config.from_dict(copy.deepcopy(d_proxy)), H.dims_for(d_proxy),
                                device="cpu"), seed=0),
        jtrainer.build_model(JConfig.from_dict(copy.deepcopy(d_proxy)), H.dims_for(d_proxy)),
        batch0)

    def forward_matches(d):
        model = jtrainer.build_model(JConfig.from_dict(copy.deepcopy(d)), H.dims_for(d))
        apply = H.compiled(jax.jit(lambda v, b: model.apply(v, b, deterministic=True)),
                           variables, batch0)
        port = H.port_model(d, variables)
        for s in (1, 2):
            batch = H.make_batch(d, B=8, seed=s)
            want = [np.asarray(a, np.float32) for a in apply(variables, batch)]
            with torch.inference_mode():
                got = [t.float().numpy() for t in port(H.torch_batch(batch))]
            for w, g in zip(want, got):
                assert g.shape == w.shape
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)

    def labelled_batch(d, seed):
        b = H.make_batch(d, B=8, seed=seed)
        b["y"] = (np.arange(8) % 3 == 0).astype(np.float32)
        return b

    def rel_close(name, got, want, rel):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        top = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= rel * max(top, 1e-30), f"{name}: err {err} > {rel} x {top}"

    def sparse_step_matches():
        d = _cfg(encoder=False, **PROXY)
        batch = labelled_batch(d, 11)
        # the same parameters without the encoder layer
        dare = {k: v for k, v in variables["params"]["dare"].items() if not k.startswith("layer_")}
        step_vars = {"params": {**variables["params"], "dare": dare}}
        jmodel = jtrainer.build_model(JConfig.from_dict(copy.deepcopy(d)), H.dims_for(d))

        def jax_loss_and_grads(params, batch):
            rest, tables = jtrainer.extract_tables(params)
            B, K, D = batch["seq"].shape[0], 8, d["model"]["emb_dim"]
            perts0 = {"dare": {"table_rows": jnp.zeros((B, K, 2 * D), jnp.float32)}}

            def loss_fn(rest_params, perts):
                full = jtrainer.insert_tables(rest_params, tables)
                (z, _, aux), _ = jmodel.apply({**full, "perturbations": perts}, batch,
                                              deterministic=True, mutable=["intermediates"])
                return jax_bce(z, batch["y"]) + 0.1 * jax_bce(aux, batch["y"])

            loss, (g_rest, g_perts) = jax.value_and_grad(loss_fn, argnums=(0, 1))(rest, perts0)
            return loss, g_rest, g_perts["dare"]["table_rows"]

        cfg = Config.from_dict(copy.deepcopy(d))
        model = H.port_model(d, step_vars)
        assert model.dare.n_layers == 0
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        state = trainer.make_train_state(cfg, model, tx)
        step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)

        # the loss and gradients, the table rows' through the taps
        jloss, jg_rest, jg_rows = H.compiled(jax.jit(jax_loss_and_grads), step_vars,
                                             batch)(step_vars, batch)
        taps = {}
        z, _, aux = model(H.torch_batch(batch), taps=taps)
        y = torch.from_numpy(batch["y"])
        loss = bce_wll_style(z, y) + 0.1 * bce_wll_style(aux, y)
        loss.backward()
        rel_close("loss", float(loss.detach()), float(jloss), 1e-4)
        jg = flax_to_state_dict(jax.device_get(jg_rest))
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        assert set(jg) == set(grads), sorted(set(jg) ^ set(grads))
        for n, g in grads.items():
            rel_close(f"grad {n}", g.numpy(), jg[n].numpy(), 1e-4)
        rel_close("grad table_rows", taps["table_rows"].grad.numpy(), np.asarray(jg_rows), 1e-4)
        for p in model.parameters():
            p.grad = None

        # then the port's whole step on it: the loss it reports, and only the
        # rows the proxy selected move
        table0 = model.dare.emb_tables.detach().clone()
        state, step_loss = step(state, H.torch_batch(batch))
        rel_close("step loss", float(step_loss), float(jloss), 1e-4)
        changed = torch.nonzero((model.dare.emb_tables != table0).any(dim=1))[:, 0]
        touched = set(taps["sel_ids"].reshape(-1).tolist()) - {0}
        assert len(changed) and set(changed.tolist()) <= touched

    checks = H.Checks()
    with H.torch_threads():
        for top_k, chunk in ((5, 7), (12, 16), (40, 39), (40, 7), (5, 39)):
            against_jax = (top_k, chunk) == (12, 16)
            checks.run(f"streaming top_k={top_k} chunk={chunk}", streaming_bit_equal,
                       top_k, chunk, against_jax)
            checks.run(f"proxy block 1 top_k={top_k}", proxy_block1_bit_equal, top_k,
                       max(top_k, 20))
        for top_k, block, candidates in ((5, 4, 12), (8, 16, 30)):
            checks.run(f"proxy block {block} top_k={top_k} candidates={candidates}",
                       proxy_matches_jax, top_k, block, candidates)
        checks.run("decay", decay_unchanged)
        checks.run("forward fp32, streaming", forward_matches, _cfg(**CHUNK))
        checks.run("forward fp32, proxy", forward_matches, _cfg(**PROXY))
        checks.run("sparse step, proxy", sparse_step_matches)
    checks.done()
