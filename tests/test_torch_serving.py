"""The port's serving slice against the JAX package's, end to end on CPU.

A cache written by the port's ``data/synth.py`` (three shards, a partial
last batch) and two fold checkpoints written by the JAX package
(``jitted_init``, then ``save_fold_checkpoint`` with an EMA tree and a
temperature ``Calibrator``; fold 1's msgpack written with a small
``MAX_CHUNK_SIZE`` so every large leaf takes flax's chunked form) are
served by both packages' ``predict_ensemble``.  Ids must be identical;
the ensembled probabilities agree to 1e-5 (fp32: the per-fold logits
agree to ~1e-7, and the temperature and logit-mean ensemble are smooth).
Also checked: the port's own checkpoint format serves the same numbers,
``infer_main`` and the CLI write the submission CSV, the msgpack reader
matches flax's, and the calibrator unpickler.  One test item (see
``_torch_helpers``).
"""

import copy
import csv
import io
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

import _torch_helpers as H

ROWS = 20  # batches of 8: the last holds 4 real rows and 4 repeats
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_side(root):
    """Cache + two JAX fold checkpoints; -> (config dict, manifest, exp
    dir, the JAX package's predict_ensemble output)."""
    import flax.serialization
    import jax

    from tossctr_tpu.config import Config as JaxConfig
    from tossctr_tpu.data.dataset import ShardCache as JaxShardCache
    from tossctr_tpu.eval.calibration import Calibrator, TemperatureScaler
    from tossctr_tpu.infer.predict import predict_ensemble
    from tossctr_tpu.train.checkpoint import save_fold_checkpoint
    from tossctr_tpu.train.trainer import build_model
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data.synth import write_synth_cache_for

    d = H.tiny_cfg_dict("none", exp_name="tiny_serve", logging={"log_dir": str(root / "runs")})
    man = write_synth_cache_for(Config.from_dict(copy.deepcopy(d)), str(root / "cache"),
                                ROWS, num_dim=H.NUM_DIM, shard_rows=7, seed=3)
    d["data"]["manifest_test"] = man
    jcfg = JaxConfig.from_dict(copy.deepcopy(d))
    jcache = JaxShardCache(man)
    init_batch = jcache.gather(np.arange(8), train=False)
    init_batch.pop("ids")
    # jitted_init, compiled once, on XLA's attention and FFN: the
    # parameters do not depend on the kernel switches
    # (``_torch_helpers.jax_model_and_variables``)
    plain = copy.deepcopy(d)
    plain["model"].update(use_pallas_attention=False, use_pallas_ffn=False)
    plain_model = build_model(JaxConfig.from_dict(plain), jcache.dims)
    init = jax.jit(lambda k, b: plain_model.init(k, b, deterministic=True))
    for fold in (0, 1):
        v = init(jax.random.PRNGKey(fold), init_batch)
        params = {"params": v["params"]}
        ema = jax.tree_util.tree_map(lambda a: (a * 1.05).astype(a.dtype), params)
        cal = Calibrator(method="temperature")
        cal.temp_scaler = TemperatureScaler(T=1.3 + 0.5 * fold)
        with pytest.MonkeyPatch.context() as mp:
            if fold == 1:
                mp.setattr(flax.serialization, "MAX_CHUNK_SIZE", 512)
            save_fold_checkpoint(jcfg.exp_dir(), fold, params=params, cfg_dict=jcfg.to_dict(),
                                 best_score=0.4 + 0.1 * fold, epoch=1, global_step=10,
                                 ema_shadow=ema, calibrator=cal)
    return d, man, jcfg.exp_dir(), predict_ensemble(jcfg, jcache)


def test_serving_slice_matches_jax(tmp_path):
    import flax.serialization
    import jax.numpy as jnp
    import torch
    import yaml

    from tossctr_tpu.eval.calibration import Calibrator as JaxCalibrator
    from tossctr_tpu.eval.calibration import TemperatureScaler as JaxTemperatureScaler
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.infer import infer_main, load_fold_models, predict_ensemble
    from tossctr_tpu_torch.train import flax_msgpack
    from tossctr_tpu_torch.train.checkpoint import (
        list_fold_checkpoints,
        load_fold_checkpoint,
        load_legacy_calibrator,
        save_fold_checkpoint,
    )

    d, man, exp_dir, want = _jax_side(tmp_path / "jax")

    def chunked_checkpoint_was_written():
        with open(os.path.join(exp_dir, "ckpt_folds_1", "params.msgpack"), "rb") as f:
            assert b"__msgpack_chunked_array__" in f.read()
        with open(os.path.join(exp_dir, "ckpt_folds_0", "params.msgpack"), "rb") as f:
            assert b"__msgpack_chunked_array__" not in f.read()

    def padded_last_batch():
        batches = list(BatchIterator(ShardCache(man), batch_size=8))
        assert len(batches) == 3
        last = batches[-1]
        assert last["valid"].tolist() == [1.0] * 4 + [0.0] * 4
        assert (last["seq"][4:] == last["seq"][3]).all()
        assert (last["ids"][4:] == last["ids"][3]).all()

    def predict_ensemble_matches():
        got = predict_ensemble(Config.from_dict(copy.deepcopy(d)), ShardCache(man), device="cpu")
        np.testing.assert_array_equal(got["ids"], want["ids"])
        assert got["ids"].shape == (ROWS,) and len(set(got["ids"])) == ROWS
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5, rtol=0)

    def ema_overrides_params():
        cfg = Config.from_dict(copy.deepcopy(d))
        models, cals, scores = load_fold_models(cfg, ShardCache(man).dims, device="cpu")
        ck = load_fold_checkpoint(list_fold_checkpoints(exp_dir)[0])
        key = "dare.layer_0.mha.qkv.kernel"
        torch.testing.assert_close(models[0].state_dict()[key], ck["ema"][key])
        torch.testing.assert_close(ck["ema"][key], ck["params"][key] * 1.05)
        assert scores == pytest.approx([0.4, 0.5])
        assert [c.temp_scaler.T for c in cals] == pytest.approx([1.3, 1.8])

    def port_checkpoint_format_serves_the_same():
        dd = copy.deepcopy(d)
        dd["logging"]["log_dir"] = str(tmp_path / "port")
        cfg = Config.from_dict(dd)
        for fold, ckpt_dir in enumerate(list_fold_checkpoints(exp_dir)):
            ck = load_fold_checkpoint(ckpt_dir)
            save_fold_checkpoint(cfg.exp_dir(), fold, state_dict=ck["ema"],
                                 calibrator=ck["calibrator"], cfg_dict=cfg.to_dict(),
                                 best_score=ck["score"], epoch=1, global_step=10)
        assert os.path.exists(os.path.join(cfg.exp_dir(), "ckpt_folds_1", "calibrator.json"))
        got = predict_ensemble(cfg, ShardCache(man), device="cpu")
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5, rtol=0)

    def read_submission(path):
        with open(path) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["ID", "clicked"]
        assert [r[0] for r in rows[1:]] == list(want["ids"])
        probs = np.array([float(r[1]) for r in rows[1:]])
        assert ((probs > 0) & (probs < 1)).all()
        np.testing.assert_allclose(probs, want["probs"], atol=1e-5 + 5e-9, rtol=0)

    def infer_main_writes_submission():
        cfg = Config.from_dict(copy.deepcopy(d))
        path = infer_main(cfg, device="cpu")
        assert path == os.path.join(cfg.exp_dir(), "submission.csv")
        read_submission(path)

    def cli_serves_a_yaml_config():
        dd = copy.deepcopy(d)
        dd["logging"]["log_dir"] = str(tmp_path / "cli")
        shutil.copytree(exp_dir, tmp_path / "cli" / dd["exp_name"])
        cfg_path = tmp_path / "serve.yaml"
        cfg_path.write_text(yaml.safe_dump(dd))
        r = subprocess.run(
            [sys.executable, "-m", "tossctr_tpu_torch.infer", "--cfg", str(cfg_path),
             "--device", "cpu"],
            capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO), timeout=300,
        )
        assert r.returncode == 0, r.stderr
        sub = tmp_path / "cli" / dd["exp_name"] / "submission.csv"
        assert f"[infer] wrote {sub}" in r.stdout
        read_submission(sub)

    def msgpack_reader_matches_flax():
        rng = np.random.default_rng(0)
        tree = {"params": {
            "emb": jnp.asarray(rng.normal(size=(70, 16)), jnp.bfloat16),
            "dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                      "bias": np.zeros((3,), np.float32)},
            "ids": np.arange(300, dtype=np.int32),
            "scalar": np.float32(2.5),
        }}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
            blob = flax.serialization.msgpack_serialize(tree)
        assert b"__msgpack_chunked_array__" in blob
        ref = flax.serialization.msgpack_restore(blob)["params"]
        got = flax_msgpack.loads(blob)["params"]
        assert got["emb"].dtype == torch.bfloat16 and got["emb"].shape == (70, 16)
        np.testing.assert_array_equal(got["emb"].float().numpy(),
                                      np.asarray(ref["emb"]).astype(np.float32))
        np.testing.assert_array_equal(got["dense"]["kernel"].numpy(), ref["dense"]["kernel"])
        np.testing.assert_array_equal(got["ids"].numpy(), ref["ids"])
        assert float(got["scalar"]) == 2.5

    def calibrator_unpickler():
        def load(obj):
            path = tmp_path / "calibrator.pkl"
            path.write_bytes(pickle.dumps(obj))
            return load_legacy_calibrator(str(path))

        cal = JaxCalibrator(method="temperature")
        cal.temp_scaler = JaxTemperatureScaler(T=0.7)
        z = np.linspace(-4, 4, 9)
        np.testing.assert_allclose(load(cal).predict_proba(z), cal.predict_proba(z), rtol=1e-12)
        iso = JaxCalibrator(method="isotonic").fit(np.linspace(-3, 3, 40), np.arange(40) % 2)
        with pytest.raises(NotImplementedError):
            load(iso)
        with pytest.raises(pickle.UnpicklingError):
            load(io.StringIO("x"))

    checks = H.Checks()
    with H.torch_threads():
        for fn in (chunked_checkpoint_was_written, padded_last_batch, predict_ensemble_matches,
                   ema_overrides_params, port_checkpoint_format_serves_the_same,
                   infer_main_writes_submission, cli_serves_a_yaml_config,
                   msgpack_reader_matches_flax, calibrator_unpickler):
            checks.run(fn.__name__, fn)
    checks.done()
