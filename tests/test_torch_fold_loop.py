"""The port's K-fold loop end to end on the CPU: ``train_main`` on a tiny
config with the FM-cross kernel path (``model.extra.use_pallas_fm``, F =
16 QNN tokens), the row-sparse table step, one fold (``cv.n_splits: 1``)
of two epochs, on a synthetic shard cache:

* ``train_log.csv`` holds one val and one val_cal row per epoch, finite;
* the checkpoint contract: ``ckpt_folds_0/`` holds meta.json (the best
  epoch and its calibrated score), params.pt (every weight), ema.pt (the
  EMA weights of the tracked parameters: not the table) and
  calibrator.json; the step-resume state file is gone; what
  ``load_fold_checkpoint`` serves is the EMA weights merged with the
  table;
* fold-skip resume: a second ``train_main`` trains nothing and leaves
  the checkpoint as it was;
* ``infer_main`` on the result writes a submission equal (to the
  8 decimals it prints) to the calibrated forward of the merged EMA
  weights;
* mid-epoch step resume: a fold killed after step 5 (state saved every 2
  steps) and started again repeats the uninterrupted fold's losses from
  step 5 on and ends with the same weights, table, AdaGrad accumulator
  and EMA, bit for bit (as ``tests/test_step_resume.py`` holds the JAX
  package's);
* configs that ask for what the loop does not port raise.

One test item (see ``_torch_helpers``).
"""

import copy
import csv
import json
import os

import numpy as np
import pytest

import _torch_helpers as H



def loop_cfg_dict(root):
    return H.tiny_cfg_dict("none", data=H.FM_CATS, **{
        "model": {"extra": {"use_pallas_fm": True}},
        "train": {"batch_size": 32, "epochs": 2, "embedding_optimizer": "rowwise_adagrad",
                  "exact_dedup": True, "step_checkpointing": True},
        "cv": {"n_splits": 1},
        "ema": {"enabled": True, "decay": 0.9},
        "logging": {"log_dir": os.path.join(root, "runs"), "tb": False},
    })


class _Quiet:
    def row(self, **kw):
        pass

    def csv(self, **kw):
        pass

    def scalars(self, *a, **kw):
        pass

    def throughput(self, *a, **kw):
        pass


def test_fold_loop_end_to_end(tmp_path, monkeypatch):
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.infer.predict import infer_main
    from tossctr_tpu_torch.models import build_model
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.checkpoint import load_fold_checkpoint

    root = str(tmp_path)
    d = loop_cfg_dict(root)
    base = Config.from_dict(copy.deepcopy(d))
    d["data"]["manifest_train"] = write_synth_cache_for(base, os.path.join(root, "train"), 320,
                                                        num_dim=H.NUM_DIM, seed=1)
    d["data"]["manifest_test"] = write_synth_cache_for(base, os.path.join(root, "test"), 70,
                                                       num_dim=H.NUM_DIM, seed=2)
    cfg = Config.from_dict(d)
    exp = cfg.exp_dir()
    ck = os.path.join(exp, "ckpt_folds_0")
    monkeypatch.setattr(trainer.Logger, "row", lambda self, **kw: None)  # quiet console

    def trains_and_logs():
        assert trainer.train_main(cfg, device="cpu") == exp
        with open(os.path.join(exp, "train_log.csv")) as f:
            rows = list(csv.DictReader(f))
        assert [(r["epoch"], r["split"]) for r in rows] == [
            ("1", "val"), ("1", "val_cal"), ("2", "val"), ("2", "val_cal")], rows
        for r in rows:
            assert all(np.isfinite(float(r[k])) for k in ("AP", "WLL", "Score"))
            assert r["split"] == "val_cal" or np.isfinite(float(r["loss"]))

    def checkpoint_contract():
        assert sorted(os.listdir(ck)) == ["calibrator.json", "ema.pt", "meta.json", "params.pt"]
        assert not os.path.exists(os.path.join(exp, "fold_0_state.pt"))
        with open(os.path.join(ck, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(exp, "train_log.csv")) as f:
            cal = [r for r in csv.DictReader(f) if r["split"] == "val_cal"]
        best = max(cal, key=lambda r: float(r["Score"]))
        assert meta["epoch"] == int(best["epoch"]) and meta["fold"] == 0
        assert abs(meta["score"] - float(best["Score"])) < 1e-9
        assert meta["cfg"]["model"]["use_pallas_fm"] is True
        model = build_model(cfg, {"X_num": H.NUM_DIM, "X_mask": H.NUM_DIM, "X_cat": 5,
                                  "seq_len": 24}, device="cpu")
        params = torch.load(os.path.join(ck, "params.pt"), weights_only=True)
        model.load_state_dict(params, strict=True)
        ema = torch.load(os.path.join(ck, "ema.pt"), weights_only=True)
        assert "dare.emb_tables" not in ema and "qnn.U" in ema and "qnn.V" in ema
        assert not torch.equal(ema["qnn.U"], params["qnn.U"])
        got = load_fold_checkpoint(ck)
        assert got["calibrator"] is not None and got["calibrator"].temp_scaler is not None
        assert set(got["ema"]) == set(params)
        assert torch.equal(got["ema"]["dare.emb_tables"], params["dare.emb_tables"])
        assert torch.equal(got["ema"]["qnn.U"], ema["qnn.U"])

    def fold_skip_resume():
        before = {f: os.path.getmtime(os.path.join(ck, f)) for f in os.listdir(ck)}
        rows = []
        monkeypatch.setattr(trainer.Logger, "row", lambda self, **kw: rows.append(kw))
        monkeypatch.setattr(trainer, "train_one_fold", lambda *a, **k: pytest.fail("trained"))
        trainer.train_main(cfg, device="cpu")
        monkeypatch.undo()
        assert [r.get("split") for r in rows] == ["device", "skip"], rows
        assert {f: os.path.getmtime(os.path.join(ck, f)) for f in os.listdir(ck)} == before

    def serves_what_validation_scored():
        from tossctr_tpu_torch.data import BatchIterator, ShardCache

        path = infer_main(cfg, device="cpu")
        with open(path) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["ID", "clicked"] and len(rows) == 71
        probs = np.array([float(r[1]) for r in rows[1:]])
        ckpt = load_fold_checkpoint(ck)
        cache = ShardCache(cfg.data.manifest_test)
        model = build_model(cfg, cache.dims, device="cpu")
        model.load_state_dict(ckpt["ema"], strict=True)
        zs = []
        with torch.inference_mode():
            for b in BatchIterator(cache, batch_size=cfg.train.batch_size):
                tb = {k: torch.from_numpy(b[k]) for k in ("X_num", "X_mask", "X_cat", "seq")}
                zs.append(model(tb)[0].numpy()[b["valid"].astype(bool)])
        want = ckpt["calibrator"].predict_proba(np.concatenate(zs))
        assert np.abs(probs - want).max() <= 5e-9

    def step_resume_bit_exact():
        rc = copy.deepcopy(d)
        rc["train"].update(epochs=1, step_checkpoint_interval=2)
        idx = np.arange(320)
        idx_tr, idx_va = idx[:256], idx[256:]  # 8 steps of 32
        real = trainer.make_train_step

        def run(name, kill_at=None):
            c = Config.from_dict({**rc, "exp_name": name})
            os.makedirs(c.exp_dir(), exist_ok=True)
            losses, last = [], {}

            def wrapped(*a, **k):
                step = real(*a, **k)

                def go(state, batch):
                    if kill_at is not None and len(losses) == kill_at:
                        raise KeyboardInterrupt("killed")
                    state, loss = step(state, batch)
                    losses.append(float(loss))
                    last["state"] = state
                    return state, loss

                return go

            monkeypatch.setattr(trainer, "make_train_step", wrapped)
            try:
                trainer.train_one_fold(c, 0, idx_tr, idx_va, c.data.manifest_train, _Quiet(),
                                       device="cpu")
            except KeyboardInterrupt:
                pass
            finally:
                monkeypatch.undo()
            return c, losses, last.get("state")

        _, base, want = run("resume_base")
        assert len(base) == 8
        c, killed, _ = run("resume_kill", kill_at=5)
        assert killed == base[:5]
        state_file = os.path.join(c.exp_dir(), "fold_0_state.pt")
        assert os.path.exists(state_file)
        assert not os.path.exists(os.path.join(c.exp_dir(), "ckpt_folds_0", "meta.json"))
        saved = torch.load(state_file, weights_only=True)
        assert saved["loop"]["step_in_epoch"] == 4 and saved["step"] == 4
        _, resumed, got = run("resume_kill")
        assert resumed == base[4:], (resumed, base)
        assert got.step == want.step == 8
        a, b = want.model.state_dict(), got.model.state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert torch.equal(want.table_opt["emb_tables"].accum, got.table_opt["emb_tables"].accum)
        assert want.ema.num_updates == got.ema.num_updates
        for k, s in want.ema.shadow.items():
            assert torch.equal(s, got.ema.shadow[k]), k

    def unported_raise():
        for over in ({"mesh": {"data": 2}}, {"mesh": {"model": 2}}, {"debug_nans": True}):
            c = Config.from_dict({**copy.deepcopy(d), **over})
            with pytest.raises(NotImplementedError):
                trainer.train_main(c, device="cpu")

    checks = H.Checks()
    with H.torch_threads(2):
        checks.run("train_main: two epochs logged", trains_and_logs)
        checks.run("checkpoint contract", checkpoint_contract)
        checks.run("fold-skip resume", fold_skip_resume)
        checks.run("infer_main serves what validation scored", serves_what_validation_scored)
        checks.run("mid-epoch step resume is bit-exact", step_resume_bit_exact)
        checks.run("unported options raise", unported_raise)
    checks.done()
