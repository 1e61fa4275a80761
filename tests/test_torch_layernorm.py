"""The port's LayerNorm and unfused encoder paths against the JAX package.

* ``LayerNorm`` against flax's ``nn.LayerNorm`` (the fast variance
  mean(x^2) - mean(x)^2 clipped at 0, fp32 statistics) at widths 16, 64
  and 12,800 (the QNN-alpha head's F*D), with an all-zero row: fp32 within
  1e-6 of the largest magnitude (at least 1), bf16 within 3 bf16 ulps of
  it.  The inputs are centred as the model's are: with a common offset
  many times the spread the fast variance cancels, and two sums of 12,800
  terms taken in different orders then part by more than this band.
* ``DAREEncoderLayer`` against the JAX layer in every branch (rms and
  layer x the attention kernel on and off x the FFN kernel on and off,
  rms with both kernels with and without ``fuse_block``), fp32,
  deterministic, on random parameters (LayerNorm scales and biases away
  from 1 and 0): the output and the gradients of x and of every
  parameter within 1e-5 of each one's largest magnitude (at least 1).
  ``fuse_block=None`` follows ``TOSSCTR_DISABLE_FUSE_BLOCK``.
* The whole ``CTRModel`` with ``sequence.tfm.norm: layer`` and
  ``model.qnn_alpha.norm: layer`` (one encoder layer; the unfused encoder
  is held in ``test_torch_model.py``): logits, probabilities and the aux
  logit within 1e-4; and one fp32 sparse train step of the LayerNorm model from one state against the JAX step (as
  ``test_torch_train_step.py`` holds the RMSNorm model): the loss and
  every gradient within 1e-4, then the state after one ``make_train_step``.
* The converter and the fold checkpoints: a legacy JAX checkpoint whose
  layers still carry flax's auto names ``LayerNorm_0`` / ``LayerNorm_1``
  loads as ``norm1`` / ``norm2`` (``qnn/LayerNorm_0`` keeps its name), the
  JAX package's own migration agreeing; the port's format saves and loads
  the LayerNorm keys.
* ``build_model`` accepts the four settings it refused before, the split
  tables and streaming and proxy selection; ``_check_ported`` still
  refuses more than one device (``mesh.model: 2``).

One test item (see ``_torch_helpers``).
"""

import copy

import numpy as np
import pytest

import _torch_helpers as H

LR = 1e-2
AUX_W = 0.1
BOTH_LAYER = {"sequence": {"tfm": {"norm": "layer"}}, "model": {"qnn_alpha": {"norm": "layer"}}}
UNFUSED = {"model": {"use_pallas_attention": False, "use_pallas_ffn": False}}


def _close(name, got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * max(top, 1.0), f"{name}: err {err} > {rel} x max({top}, 1)"


def _layer_params(norm, K, D, n_heads, ffn_hidden, seed):
    """A random flax parameter tree of one encoder layer (the tree
    ``DAREEncoderLayer.init`` makes), norm scales and biases away from 1
    and 0: built from numpy, since ``init`` would run the Pallas kernels."""
    rng = np.random.default_rng(seed)

    def r(*shape, mean=0.0, sd=0.1):
        return (mean + rng.normal(0, sd, shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": r(i, o, sd=i ** -0.5), "bias": r(o)}

    def norm_params():
        if norm == "rms":
            return {"w": r(D, mean=1.0)}
        return {"LayerNorm_0": {"scale": r(D, mean=1.0), "bias": r(D)}}

    return {"pbias": {"rel": r(2 * K + 1, n_heads, sd=1.0)},
            "mha": {"qkv": dense(D, 3 * D), "out": dense(D, D)},
            "norm1": norm_params(), "Dense_0": dense(D, ffn_hidden),
            "Dense_1": dense(ffn_hidden, D), "norm2": norm_params()}


def test_layernorm_paths_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.models.layers import DAREEncoderLayer as JaxLayer
    from tossctr_tpu.models.layers import LayerNorm as JaxLayerNorm
    from tossctr_tpu.train import checkpoint as jckpt
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu.train.loss import bce_wll_style as jax_bce
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict, load_flax_train_state
    from tossctr_tpu_torch.models import build_model
    from tossctr_tpu_torch.models.layers import DAREEncoderLayer, LayerNorm
    from tossctr_tpu_torch.train import checkpoint, trainer
    from tossctr_tpu_torch.train.loss import bce_wll_style

    def layer_norm(width, dtype):
        rng = np.random.default_rng(width)
        x = rng.normal(0.2, 1.0, (6, width)).astype(np.float32)
        x[0] = 0.0  # an empty-history-like row: var 0, the output is the bias
        scale = rng.normal(1, 0.1, width).astype(np.float32)
        bias = rng.normal(0, 0.1, width).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        jm = JaxLayerNorm(dtype=jdt)
        jx = jnp.asarray(x, jdt)
        variables = {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}
        want = np.asarray(H.run_once(jm.apply, variables, jx)).astype(np.float32)
        tm = LayerNorm(width)
        tm.load_state_dict(flax_to_state_dict(variables), strict=True)
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        got = tm(torch.from_numpy(x).to(tdt), tdt)
        assert got.dtype == tdt
        got = got.float().detach().numpy()
        band = 1e-6 * max(float(np.abs(want).max()), 1.0) if dtype == "f32" else H.bf16_band(want)
        assert float(np.abs(got - want).max()) <= band, float(np.abs(got - want).max())

    B, K, D, NH, FH = 3, 8, 16, 2, 32

    def encoder_layer(norm, attn, ffn, fuse_block):
        rng = np.random.default_rng(5)
        x = rng.normal(0, 1, (B, K, D)).astype(np.float32)
        g = rng.normal(0, 1, (B, K, D)).astype(np.float32)
        jl = JaxLayer(d_model=D, n_heads=NH, mha_dropout=0.1, ffn_hidden=FH, ffn_dropout=0.1,
                      norm=norm, max_len=K, use_pallas_attn=attn, use_pallas_ffn=ffn,
                      fuse_block=fuse_block, valid_k=K - 2)
        params = _layer_params(norm, K, D, NH, FH, seed=1)

        def jloss(p, x_):
            out = jl.apply({"params": p}, x_, deterministic=True)
            return jnp.sum(out * g), out

        jx = jnp.asarray(x)
        grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
        (_, jout), (jgp, jgx) = H.compiled(grads, params, jx)(params, jx)
        tl = DAREEncoderLayer(D, NH, FH, mha_dropout=0.1, ffn_dropout=0.1, norm=norm,
                              max_len=K, use_pallas_attn=attn, use_pallas_ffn=ffn,
                              fuse_block=fuse_block)
        tl.load_state_dict(flax_to_state_dict(params), strict=True)
        assert tl.fused_block() == (norm == "rms" and attn and ffn and fuse_block)
        tx = torch.from_numpy(x).requires_grad_()
        out = tl(tx, valid_k=K - 2)
        (out * torch.from_numpy(g)).sum().backward()
        _close("out", out.detach().numpy(), np.asarray(jout), 1e-5)
        _close("dx", tx.grad.numpy(), np.asarray(jgx), 1e-5)
        jg = flax_to_state_dict(jax.device_get(jgp))
        assert set(jg) == {n for n, _ in tl.named_parameters()}
        for n, prm in tl.named_parameters():
            _close(f"d{n}", prm.grad.numpy(), jg[n].numpy(), 1e-5)

    def fuse_block_follows_the_environment():
        layer = DAREEncoderLayer(D, NH, FH)
        assert layer.fused_block()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TOSSCTR_DISABLE_FUSE_BLOCK", "1")
            assert not layer.fused_block()
        assert not DAREEncoderLayer(D, NH, FH, norm="layer").fused_block()

    def train_cfg():
        d = H.tiny_cfg_dict("none", **copy.deepcopy(BOTH_LAYER))
        d["sequence"]["tfm"].update(n_layers=1, mha_dropout=0.0, ffn_dropout=0.0)
        d["model"].update(dare_dropout=0.0, embedding_dropout=0.0, dropout_impl="hash")
        d["model"]["qnn_alpha"].update(dropout=0.0, aux_head_weight=AUX_W)
        d["train"].update(batch_size=8, epochs=2, warmup_epochs=1, lr=LR, weight_decay=1e-2,
                          grad_clip_norm=0.5, embedding_optimizer="rowwise_adagrad",
                          exact_dedup=True)
        d["ema"] = {"enabled": True, "decay": 0.9}
        return d

    d = train_cfg()
    dims = H.dims_for(d)
    batch = H.make_batch(d, B=8, seed=11)
    batch["y"] = (np.arange(8) % 3 == 0).astype(np.float32)
    jcfg = JConfig.from_dict(copy.deepcopy(d) | {"logging": {"log_dir": str(tmp_path)}})
    jmodel, variables = H.jax_model_and_variables(d, {k: v for k, v in batch.items() if k != "y"})
    # a host copy: the JAX train step donates the state's buffers
    params = jax.tree_util.tree_map(np.array, variables["params"])

    def model_logits():
        apply = jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True))
        port = H.port_model(d, {"params": params})
        for s in (1, 2):
            b = H.make_batch(d, B=8, seed=s)
            if s == 1:  # both batches have one layout
                apply = H.compiled(apply, {"params": params}, b)
            want = [np.asarray(a, np.float32) for a in apply({"params": params}, b)]
            with torch.inference_mode():
                got = [t.numpy() for t in port(H.torch_batch(b))]
            for name, w, g in zip(("logits", "probabilities", "aux"), want, got):
                _close(f"{name} seed={s}", g, w, 1e-4)

    def train_step():
        jtx, jsched = jtrainer.make_optimizer(jcfg, steps_per_epoch=4)
        jstate, jmask = jtrainer.make_train_state(jcfg, variables, jtx)
        jstep = jtrainer.make_train_step(jmodel, jtx, jcfg, jax.random.PRNGKey(1),
                                         ema_mask=jmask, schedule=jsched)

        def jax_loss_and_grads(params):
            rest, tables = jtrainer.extract_tables(params)
            perts0 = {"dare": {"table_rows": jnp.zeros((8, K, 2 * D), jnp.float32)}}

            def loss_fn(rest_params, perts):
                full = jtrainer.insert_tables(rest_params, tables)
                (z, _, aux), _ = jmodel.apply({**full, "perturbations": perts}, batch,
                                              deterministic=True, mutable=["intermediates"])
                return jax_bce(z, batch["y"]) + AUX_W * jax_bce(aux, batch["y"])

            grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
            return H.compiled(grads, rest, perts0)(rest, perts0)

        cfg = Config.from_dict(copy.deepcopy(d))
        model = trainer.build_model(cfg, dims, device="cpu")
        tx, sched = trainer.make_optimizer(cfg, steps_per_epoch=4)
        state = trainer.make_train_state(cfg, model, tx)
        load_flax_train_state(state, jax.device_get(jstate))
        step = trainer.make_train_step(model, tx, cfg, base_seed=1, schedule=sched)

        jloss, (jg_rest, jg_perts) = jax_loss_and_grads(jstate.params)
        taps = {}
        z, _, aux = model(H.torch_batch(batch), taps=taps)
        y = torch.from_numpy(batch["y"])
        loss = bce_wll_style(z, y) + AUX_W * bce_wll_style(aux, y)
        loss.backward()
        _close("loss", float(loss.detach()), float(jloss), 1e-4)
        jg = flax_to_state_dict(jax.device_get(jg_rest))
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        assert set(jg) == set(grads) == set(trainer.dense_params(model))
        assert any("LayerNorm_0.scale" in n for n in grads)
        for n, g in grads.items():
            _close(f"grad {n}", g.numpy(), jg[n].numpy(), 1e-4)
        _close("grad table_rows", taps["table_rows"].grad.numpy(),
               np.asarray(jg_perts["dare"]["table_rows"]), 1e-4)
        for p in model.parameters():
            p.grad = None

        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        jstate, jl = H.compiled(jstep, jstate, jbatch)(jstate, jbatch)
        state, tl = step(state, H.torch_batch(batch))
        _close("step loss", float(tl), float(jl), 1e-4)
        jparams = flax_to_state_dict(jax.device_get(jstate.params))
        for n, p in model.named_parameters():
            got, want = p.detach().numpy(), jparams[n].numpy()
            if n == trainer.SEQ_TABLE:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=n)
                continue
            # Adam's first step moves a parameter by ~lr x sign(g): where g
            # is near zero a rounding difference can flip it (2 lr apart)
            big = np.abs(jg[n].numpy()) > 1e-3 * np.abs(jg[n].numpy()).max()
            np.testing.assert_allclose(got[big], want[big], rtol=1e-5, atol=1e-6, err_msg=n)
            assert np.abs(got - want).max() <= 2 * LR + 1e-6, n
        np.testing.assert_allclose(state.table_opt["emb_tables"].accum.numpy(),
                                   np.asarray(jstate.table_opt["emb_tables"].accum),
                                   rtol=1e-5, atol=1e-12)
        jshadow = flax_to_state_dict(jax.device_get(jstate.ema.shadow))
        assert set(state.ema.shadow) == set(jshadow) - {trainer.SEQ_TABLE}
        for n, s in state.ema.shadow.items():
            assert np.abs(s.numpy() - jshadow[n].numpy()).max() <= 2 * LR + 1e-6, n

    def checkpoints():
        from tossctr_tpu_torch.train.checkpoint import load_fold_checkpoint

        want = flax_to_state_dict(params)
        assert "qnn.LayerNorm_0.LayerNorm_0.scale" in want
        assert "dare.layer_0.norm1.LayerNorm_0.scale" in want
        # the layers' norms under flax's old auto names
        old = copy.deepcopy(params)
        for name, layer in old["dare"].items():
            if name.startswith("layer_"):
                layer["LayerNorm_0"], layer["LayerNorm_1"] = layer.pop("norm1"), layer.pop("norm2")
        assert jax.tree_util.tree_structure(jckpt._migrate_norm_names({"params": old})) == \
            jax.tree_util.tree_structure({"params": params})
        jckpt.save_fold_checkpoint(jcfg.exp_dir(), 0, params={"params": old},
                                   cfg_dict=jcfg.to_dict(), best_score=0.5, epoch=1,
                                   global_step=1)
        got = load_fold_checkpoint(checkpoint.fold_ckpt_dir(jcfg.exp_dir(), 0))["params"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        # the port's own format
        model = H.port_model(d, {"params": params})
        exp = str(tmp_path / "port")
        checkpoint.save_fold_checkpoint(exp, 0, state_dict=model.state_dict(), cfg_dict=d,
                                        best_score=0.5, epoch=1, global_step=1)
        back = load_fold_checkpoint(checkpoint.fold_ckpt_dir(exp, 0))["params"]
        fresh = build_model(Config.from_dict(copy.deepcopy(d)), dims, device="cpu")
        fresh.load_state_dict(back, strict=True)
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k

    def build_model_gate():
        for over in (BOTH_LAYER, UNFUSED, {"model": {"use_pallas_attention": False}},
                     {"model": {"use_pallas_ffn": False}}, {"model": {"fused_seq_tables": False}}):
            d = H.tiny_cfg_dict("none", **copy.deepcopy(over))
            build_model(Config.from_dict(d), H.dims_for(d), device="cpu")
        for over in ({"sequence": {"select_proxy": True, "select_proxy_block": 50,
                                   "select_proxy_candidates": 8}},
                     {"sequence": {"select_chunk": 8}}):
            d = H.tiny_cfg_dict("none", **over)
            build_model(Config.from_dict(d), H.dims_for(d), device="cpu")
        d = H.tiny_cfg_dict("none", mesh={"model": 2})
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            trainer._check_ported(Config.from_dict(d))

    checks = H.Checks()
    with H.torch_threads():
        for width in (16, 64, 12800):
            for dtype in ("f32", "bf16"):
                checks.run(f"LayerNorm width={width} {dtype}", layer_norm, width, dtype)
        branches = [("rms", True, True, True), ("rms", True, True, False)] + [
            (norm, attn, ffn, True) for norm in ("rms", "layer")
            for attn, ffn in ((True, False), (False, True), (False, False))] + [
            ("layer", True, True, True)]
        for norm, attn, ffn, fuse in branches:
            checks.run(f"encoder layer norm={norm} attn={attn} ffn={ffn} fuse_block={fuse}",
                       encoder_layer, norm, attn, ffn, fuse)
        checks.run("fuse_block=None follows the environment", fuse_block_follows_the_environment)
        checks.run("model, both norms layer", model_logits)
        checks.run("converter and checkpoints on old and new norm names", checkpoints)
        checks.run("one fp32 train step, both norms layer", train_step)
        checks.run("build_model's gate", build_model_gate)
    checks.done()
