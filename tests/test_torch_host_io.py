"""The port's host input and output against the JAX package: row-sharded
checkpoints, the native gather, the out-of-fold calibration tool, and the
fold loop with the modes this slice ports.

* A tree written by the JAX package's ``save_sharded_pytree`` on the
  virtual CPU devices (a mesh of data 2 x model 4: a bf16 table and an
  fp32 accumulator sharded by rows, replicated leaves, a None) read by
  ``train/sharded_ckpt.py`` bit for bit.
* A fold checkpoint whose ``params/`` and ``ema/`` the JAX package wrote
  row-sharded (its table on the mesh), with a pickled temperature
  calibrator: the port's ``load_fold_checkpoint`` reads the weights bit
  for bit, and ``predict_ensemble`` serves it within 1e-5 of the JAX
  model's calibrated probabilities (a pickled isotonic one is served in
  ``test_torch_isotonic.py`` and ``test_torch_serving.py``).
* The native gather (``native/``) is built from the port's own source
  into ``build/native/``, nothing next to the source; its batches are
  byte-equal to NumPy's (``TOSSCTR_NATIVE_GATHER=0``) over a two-shard
  cache; a failed build raises.
* ``tools/run_calibration.py`` on a five-fold experiment the JAX package
  wrote (each fold's EMA weights differing from its live ones): the
  out-of-fold logits within 1e-5 of the JAX tool's
  ``compute_oof_from_ckpts``; ``cal_meta.json`` within 1e-12 of the JAX
  tool's on the same logits, and within 1e-5 from its own replay;
  ``oof_metrics.json``'s counts; a partial run calibrates on the rows its
  folds cover.
* ``train_main`` on one fold with ``select_proxy``, ``eval.device_metrics:
  true``, ``temperature+isotonic`` and the native gather, then the
  fold's replayed out-of-fold logits through ``run_calibration``
  (``--oof-z`` / ``--oof-y``) and ``infer_main`` serving the fold with
  that calibrator: a valid submission; the loop's validation metrics (the
  device AP / WLL) within 1e-5 of the host's on the replayed scores.

Tiny shapes, the model without its encoder (its paths have tests of
their own).  One test item (see ``_torch_helpers``).
"""

import copy
import csv
import json
import os
import sys

import numpy as np

import _torch_helpers as H

ROWS, TEST_ROWS = 320, 70
METHOD = "temperature+isotonic"


def _cfg(root, name, **over):
    d = H.tiny_cfg_dict("none", **{
        "exp_name": name,
        "sequence": {"transformer_block": False},
        "model": {"seq_vocab": 304, "use_pallas_attention": False, "use_pallas_ffn": False,
                  "qnn_alpha": H.SMALL_QNN},
        "train": {"batch_size": 64, "epochs": 1, "embedding_optimizer": "rowwise_adagrad"},
        "cv": {"n_splits": 5},
        "calibration": {"enabled": True, "method": METHOD},
        "ema": {"enabled": True, "decay": 0.9},
        "logging": {"log_dir": os.path.join(root, "runs"), "tb": False},
    })
    return _merge(d, over)


def _merge(a, u):
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            _merge(a[k], v)
        else:
            a[k] = v
    return a


def test_host_io_matches_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    import torch
    import yaml
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.eval.calibration import Calibrator as JaxCalibrator
    from tossctr_tpu.eval.calibration import TemperatureScaler as JaxTemperatureScaler
    from tossctr_tpu.parallel.mesh import build_mesh
    from tossctr_tpu.tools import run_calibration as jrc
    from tossctr_tpu.train import checkpoint as jckpt
    from tossctr_tpu.train import trainer as jtrainer
    from tossctr_tpu.train.sharded_ckpt import save_sharded_pytree
    from tossctr_tpu_torch import native
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.convert import flax_to_state_dict
    from tossctr_tpu_torch.data import ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.eval.metrics import final_score, final_score_device
    from tossctr_tpu_torch.infer import infer_main, predict_ensemble
    from tossctr_tpu_torch.models import build_model, init_params
    from tossctr_tpu_torch.tools import run_calibration
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.checkpoint import load_fold_checkpoint
    from tossctr_tpu_torch.train.cv_split import StratifiedGroupKFold
    from tossctr_tpu_torch.train.sharded_ckpt import load_sharded_pytree

    root = str(tmp_path)
    base = _cfg(root, "io")
    bcfg = Config.from_dict(copy.deepcopy(base))
    train_man = write_synth_cache_for(bcfg, os.path.join(root, "train"), ROWS,
                                      num_dim=H.NUM_DIM, seed=1)
    test_man = write_synth_cache_for(bcfg, os.path.join(root, "test"), TEST_ROWS,
                                     num_dim=H.NUM_DIM, seed=2, shard_rows=40)
    dims = ShardCache(train_man).dims
    mesh = build_mesh(data=2, model=4)
    jmodel = jtrainer.build_model(JConfig.from_dict(copy.deepcopy(base)), dims)
    batch0 = ShardCache(train_man).gather(np.arange(8), train=False)
    batch0.pop("ids")

    # the flax variables of the port's seeded parameters: the tree traced
    # once, then filled from each seed's state_dict
    template = H.flax_variables_from_port(init_params(build_model(bcfg, dims, device="cpu"), 0),
                                          jmodel, batch0)

    def variables_for(seed):
        sd = init_params(build_model(bcfg, dims, device="cpu"), seed=seed).state_dict()
        return jax.tree_util.tree_map_with_path(
            lambda path, v: sd[".".join(k.key for k in path[1:])].float().numpy().astype(v.dtype),
            template)

    def sharded(variables):
        """The variables with the sequence table row-sharded on the mesh."""
        out = jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(variables))
        dare = out["params"]["dare"]
        dare["emb_tables"] = jax.device_put(dare["emb_tables"],
                                            NamedSharding(mesh, P("model", None)))
        return out

    def same_bits(got: torch.Tensor, want):
        want = np.asarray(want)
        if str(want.dtype) == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)

    def sharded_tree_bit_for_bit():
        rng = np.random.default_rng(0)
        table = rng.normal(0, 1, (64, 32)).astype(jnp.bfloat16)
        accum = rng.random(64).astype(np.float32)
        dense = rng.normal(0, 1, (8, 4)).astype(np.float32)
        tree = {"params": {"dare": {"emb_tables": jax.device_put(
                    jnp.asarray(table), NamedSharding(mesh, P("model", None)))},
                    "dense": {"w": jax.device_put(jnp.asarray(dense), NamedSharding(mesh, P()))}},
                "accum": jax.device_put(jnp.asarray(accum), NamedSharding(mesh, P("model"))),
                "none_entry": None, "step": jnp.int32(7)}
        d = save_sharded_pytree(os.path.join(root, "tree"), tree)
        assert len([f for f in os.listdir(d) if f.endswith(".npy")]) == 8  # 4 row files each
        got = load_sharded_pytree(d)
        same_bits(got["params"]["dare"]["emb_tables"], table)
        same_bits(got["params"]["dense"]["w"], dense)
        same_bits(got["accum"], accum)
        assert got["none_entry"] is None and int(got["step"]) == 7

    def sharded_fold_served():
        cfg_d = _cfg(root, "sharded", data={"manifest_test": test_man})
        jcfg = JConfig.from_dict(copy.deepcopy(cfg_d))
        live, ema = variables_for(3), variables_for(4)
        cal = JaxCalibrator("temperature")  # the isotonic pickle: test_torch_isotonic.py
        cal.temp_scaler = JaxTemperatureScaler(T=0.7)
        jckpt.save_fold_checkpoint(jcfg.exp_dir(), 0, params=sharded(live),
                                   ema_shadow=sharded(ema), cfg_dict=jcfg.to_dict(),
                                   best_score=0.5, epoch=1, global_step=5, calibrator=cal)
        ck = jckpt.fold_ckpt_dir(jcfg.exp_dir(), 0)
        assert os.path.isdir(os.path.join(ck, "params")) and os.path.isdir(os.path.join(ck, "ema"))
        got = load_fold_checkpoint(ck)
        for key, want in (("params", live), ("ema", ema)):
            want = flax_to_state_dict(want)
            assert set(got[key]) == set(want)
            for n, t in got[key].items():
                assert t.dtype == want[n].dtype, n
                assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                                   want[n].view(torch.int16) if t.dtype == torch.bfloat16
                                   else want[n]), n
        served = predict_ensemble(Config.from_dict(copy.deepcopy(cfg_d)), ShardCache(test_man),
                                  device="cpu")
        cache = ShardCache(test_man)
        b = cache.gather(np.arange(TEST_ROWS), train=False)
        ids = b.pop("ids")
        apply = H.compiled(jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True)), ema, b)
        z = np.asarray(apply(ema, b)[0], np.float64)
        want = np.clip(cal.predict_proba(z), 1e-7, 1 - 1e-7)
        np.testing.assert_array_equal(served["ids"], ids)
        np.testing.assert_allclose(served["probs"], want, rtol=0, atol=1e-5)

    def native_gather():
        from tossctr_tpu_torch.native import build as nbuild

        path = native.library_path()
        assert path.parent.name == "native" and path.parent.parent.name == "build"
        assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(nbuild.SRC)))
        cache = ShardCache(test_man)
        assert len(cache.shards) == 2
        idx = np.random.default_rng(7).permutation(TEST_ROWS)[:50]
        native.reset_gather_counts()
        fast = cache.gather(idx, train=True)
        assert native.gather_counts()["gather_rows_multi"] == 2  # a call a shard
        monkeypatch.setenv("TOSSCTR_NATIVE_GATHER", "0")
        slow = ShardCache(test_man).gather(idx, train=True)
        monkeypatch.delenv("TOSSCTR_NATIVE_GATHER")
        assert native.gather_counts()["gather_rows_multi"] == 2
        assert fast.keys() == slow.keys()
        for k in fast:
            assert fast[k].dtype == slow[k].dtype and fast[k].tobytes() == slow[k].tobytes(), k
        src = np.arange(60, dtype=np.int16).reshape(20, 3)[:, ::2]  # not contiguous
        out, = native.gather_rows_multi([src], np.array([3, 0, 19, 3]))
        assert out.tobytes() == src[[3, 0, 19, 3]].tobytes()
        # a failed build raises (a source that does not compile, built elsewhere)
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(nbuild, "SRC", bad)
        monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "native_build")
        monkeypatch.setattr(nbuild, "_lib", None)
        try:
            nbuild.load_fastgather()
        except RuntimeError as e:
            assert "failed" in str(e)
        else:
            raise AssertionError("a failed build did not raise")
        finally:
            monkeypatch.undo()

    def yaml_cfg(d, name):
        path = os.path.join(root, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        return path

    def oof_replay():
        cfg_d = _cfg(root, "oof", data={"manifest_train": train_man})
        jcfg = JConfig.from_dict(copy.deepcopy(cfg_d))
        for fold in range(5):
            jckpt.save_fold_checkpoint(jcfg.exp_dir(), fold, params=variables_for(10 + fold),
                                       ema_shadow=variables_for(20 + fold),
                                       cfg_dict=jcfg.to_dict(), best_score=0.5, epoch=1,
                                       global_step=5)
        cfg = Config.from_dict(copy.deepcopy(cfg_d))
        z, y, covered, total = run_calibration.compute_oof_from_ckpts(cfg, train_man,
                                                                      cfg.exp_dir(), "cpu")
        jz, jy, jcov, jtot = jrc.compute_oof_from_ckpts(jcfg, train_man, jcfg.exp_dir())
        assert (covered, total) == (jcov, jtot) == (ROWS, ROWS)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(z, jz, rtol=0, atol=1e-5)
        np.save(os.path.join(root, "oof_z.npy"), np.asarray(jz))
        np.save(os.path.join(root, "oof_y.npy"), np.asarray(jy))
        path = yaml_cfg(cfg_d, "oof")
        outs = {}
        for tag, tool, extra in (
                ("jax", jrc.main, ["--oof-z", os.path.join(root, "oof_z.npy"),
                                   "--oof-y", os.path.join(root, "oof_y.npy")]),
                ("port same logits", run_calibration.main,
                 ["--oof-z", os.path.join(root, "oof_z.npy"),
                  "--oof-y", os.path.join(root, "oof_y.npy"), "--device", "cpu"]),
                ("port replay", run_calibration.main, ["--device", "cpu"])):
            out = os.path.join(root, tag.replace(" ", "_"))
            monkeypatch.setattr(sys, "argv", ["run_calibration", "--cfg", path,
                                              "--out-dir", out, *extra])
            tool()
            with open(os.path.join(out, "cal_meta.json")) as f, \
                    open(os.path.join(out, "oof_metrics.json")) as g:
                outs[tag] = (json.load(f), json.load(g))
        want = outs["jax"][0]
        assert "iso_thresholds_x" in want and want["method"] == METHOD
        for tag, tol in (("port same logits", 1e-12), ("port replay", 1e-5)):
            got, metrics = outs[tag]
            assert got.keys() == want.keys() and got["method"] == want["method"]
            for k in set(want) - {"method"}:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=f"{tag} {k}")
            assert (metrics["rows"], metrics["total"]) == (ROWS, ROWS)
            for when in ("before", "after"):
                for k, v in outs["jax"][1][when].items():
                    assert abs(metrics[when][k] - v) <= 1e-5, (tag, when, k)
        # a partial run: the rows its folds cover, the full run's logits there
        os.remove(os.path.join(cfg.exp_dir(), "ckpt_folds_3", "meta.json"))
        pz, py, pcov, ptot = run_calibration.compute_oof_from_ckpts(cfg, train_man,
                                                                    cfg.exp_dir(), "cpu")
        va3 = [va for f, (_, va) in enumerate(StratifiedGroupKFold(
            n_splits=5, shuffle=True, random_state=cfg.seed).split(np.zeros(ROWS), y,
                                                                  ShardCache(train_man).groups()))
               if f == 3][0]
        kept = np.setdiff1d(np.arange(ROWS), va3)
        assert pcov == ROWS - len(va3) == len(kept) and ptot == ROWS
        np.testing.assert_array_equal(pz, z[kept])
        np.testing.assert_array_equal(py, y[kept])

    def fold_with_the_new_modes():
        cfg_d = _cfg(root, "modes", data={"manifest_train": train_man,
                                          "manifest_test": test_man},
                     sequence={"select_proxy": True, "select_proxy_block": 16,
                               "select_proxy_candidates": 12},
                     eval={"device_metrics": True}, cv={"n_splits": 1})
        cfg = Config.from_dict(copy.deepcopy(cfg_d))
        native.reset_gather_counts()
        monkeypatch.setattr(trainer.Logger, "row", lambda self, **kw: None)  # quiet console
        exp = trainer.train_main(cfg, device="cpu")
        assert native.gather_counts()["gather_rows_multi"] > 0
        with open(os.path.join(exp, "train_log.csv")) as f:
            val = next(r for r in csv.DictReader(f) if r["split"] == "val")
        z, y, covered, total = run_calibration.compute_oof_from_ckpts(cfg, train_man, exp, "cpu")
        assert 0 < covered < total  # one fold of five
        np.save(os.path.join(root, "modes_z.npy"), z)
        np.save(os.path.join(root, "modes_y.npy"), y)
        out = run_calibration.main(["--cfg", yaml_cfg(cfg_d, "modes"), "--device", "cpu",
                                    "--oof-z", os.path.join(root, "modes_z.npy"),
                                    "--oof-y", os.path.join(root, "modes_y.npy")])
        p = 1 / (1 + np.exp(-z))
        dev, host = final_score_device(y, p, device="cpu"), final_score(y, p)
        for k, (a, b) in enumerate(zip(dev, host)):
            assert abs(a - b) <= 1e-5, (k, a, b)
        # the loop's logged validation metrics are the device ones on these scores
        assert abs(float(val["AP"]) - dev[0]) <= 1e-5 and abs(float(val["WLL"]) - dev[1]) <= 1e-5
        with open(os.path.join(out, "calibrator.json")) as f:
            assert json.load(f)["iso"] is not None
        os.replace(os.path.join(out, "calibrator.json"),
                   os.path.join(exp, "ckpt_folds_0", "calibrator.json"))
        sub = infer_main(cfg, device="cpu")
        with open(sub) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["ID", "clicked"] and len(rows) == TEST_ROWS + 1
        probs = np.array([float(r[1]) for r in rows[1:]])
        assert len({r[0] for r in rows[1:]}) == TEST_ROWS
        assert np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()

    checks = H.Checks()
    with H.torch_threads(2):
        checks.run("sharded tree bit for bit", sharded_tree_bit_for_bit)
        checks.run("sharded fold served", sharded_fold_served)
        checks.run("native gather", native_gather)
        checks.run("run_calibration OOF replay", oof_replay)
        checks.run("one fold: proxy, device metrics, isotonic, native gather",
                   fold_with_the_new_modes)
    checks.done()
