"""The parts of the port's fold loop against what the JAX package uses.

* ``train.cv_split.StratifiedGroupKFold`` against scikit-learn's (which
  the JAX ``train_main`` calls): the same train and test indices, index
  for index, over seeds, fold counts, group counts (one row a group, as
  the synthetic caches have, to a few rows a group), class balances and
  a three-class target;
* ``ap_score``, ``weighted_logloss_50_50`` and ``final_score`` (both
  formulas) against ``tossctr_tpu.eval.metrics``, tied scores and a
  one-class fold included: within 1e-12;
* ``fit_temperature`` / ``Calibrator.fit`` against the JAX package's: T
  within 1e-6, calibrated probabilities within 1e-6;
* ``BalancedBatchSampler``: the batches equal the JAX package's, epoch
  by epoch, with and without the per-epoch reseed, and through
  ``BatchIterator``'s translation into the fold's global indices;
* ``load_labels_groups_for_split`` on a cache the port writes: equal to
  the JAX package's reader.

One test item (see ``_torch_helpers``).
"""

import warnings

import numpy as np

from _torch_helpers import Checks


def test_fold_parts_match_reference(tmp_path):
    from sklearn.model_selection import StratifiedGroupKFold as SkSGKF

    from tossctr_tpu.data.dataset import ShardCache as JShardCache
    from tossctr_tpu.data.dataset import load_labels_groups_for_split as j_labels_groups
    from tossctr_tpu.data.loader import BatchIterator as JBatchIterator
    from tossctr_tpu.data.sampler import BalancedBatchSampler as JBalanced
    from tossctr_tpu.eval import calibration as jcal
    from tossctr_tpu.eval import metrics as jmetrics
    from tossctr_tpu_torch.data import ShardCache
    from tossctr_tpu_torch.data.dataset import load_labels_groups_for_split
    from tossctr_tpu_torch.data.loader import BatchIterator
    from tossctr_tpu_torch.data.sampler import BalancedBatchSampler
    from tossctr_tpu_torch.data.synth import write_synth_cache
    from tossctr_tpu_torch.eval import calibration as tcal
    from tossctr_tpu_torch.eval import metrics as tmetrics
    from tossctr_tpu_torch.train.cv_split import StratifiedGroupKFold

    rng = np.random.default_rng(0)

    def sgkf(n, rows_per_group, pos, k, seed, classes=2):
        y = ((rng.random(n) < pos).astype(np.int8) if classes == 2
             else rng.integers(0, classes, n))
        groups = rng.integers(0, max(k, n // rows_per_group), n) * 7919 + 11
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = list(SkSGKF(k, shuffle=True, random_state=seed).split(np.zeros(n), y, groups))
            got = list(StratifiedGroupKFold(k, shuffle=True, random_state=seed)
                       .split(np.zeros(n), y, groups))
        assert len(got) == len(want) == k
        for i, ((tr_w, te_w), (tr_g, te_g)) in enumerate(zip(want, got)):
            assert np.array_equal(tr_w, tr_g) and np.array_equal(te_w, te_g), (
                f"fold {i}: {len(te_g)} test rows vs sklearn's {len(te_w)}")

    def metrics():
        for n, pos, ties in ((500, 0.05, 0), (2000, 0.3, 2), (300, 0.5, 1)):
            y = (rng.random(n) < pos).astype(np.float32)
            p = rng.random(n).astype(np.float32)
            if ties:
                p = np.round(p, ties)  # many tied scores
            for a, b in ((tmetrics.ap_score(y, p), jmetrics.ap_score(y, p)),
                         (tmetrics.weighted_logloss_50_50(y, p),
                          jmetrics.weighted_logloss_50_50(y, p))):
                assert abs(a - b) <= 1e-12, (a, b)
            for formula in ("reference", "competition"):
                a = tmetrics.final_score(y, p, formula=formula)
                b = jmetrics.final_score(y, p, formula=formula)
                assert np.allclose(a, b, rtol=0, atol=1e-12), (formula, a, b)
        y0 = np.zeros(50, np.float32)  # one class: the guards
        p0 = rng.random(50)
        assert tmetrics.ap_score(y0, p0) == jmetrics.ap_score(y0, p0) == 0.0
        assert np.isnan(tmetrics.weighted_logloss_50_50(y0, p0))

    def temperature():
        for scale, n in ((2.0, 4000), (0.4, 1500), (6.0, 800)):
            z = rng.normal(0, 3, n)
            y = (rng.random(n) < 1 / (1 + np.exp(-z / scale))).astype(np.int32)
            tj = jcal.fit_temperature(z, y).T
            tt = tcal.fit_temperature(z, y).T
            assert abs(tj - tt) <= 1e-6, (tj, tt)
            pj = jcal.Calibrator("temperature").fit(z, y).predict_proba(z)
            pt = tcal.Calibrator("temperature").fit(z, y).predict_proba(z)
            assert np.abs(pj - pt).max() <= 1e-6

    def balanced_sampler():
        y = (rng.random(700) < 0.1).astype(np.int8)
        for reseed in (True, False):
            # the JAX trainer's settings: with replacement, the last partial batch dropped
            kw = dict(batch_size=64, pos_fraction=0.5, seed=777, reseed_each_epoch=reseed)
            a = BalancedBatchSampler(y, **kw)
            b = JBalanced(y, replacement=True, drop_last=True, **kw)
            assert len(a) == len(b)
            for epoch in (1, 2, 3):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                for x, w in zip(a, b):
                    assert np.array_equal(x, w)

    def labels_groups_and_balanced_batches():
        man = write_synth_cache(str(tmp_path / "cache"), 900, num_dim=3, cat_cols=["a"],
                                cat_cards=[7], seq_len=8, seq_vocab=50, shard_rows=400,
                                seed=3)
        y, groups = load_labels_groups_for_split(man)
        yj, gj = j_labels_groups(man)
        assert np.array_equal(y, yj) and np.array_equal(groups, gj)
        assert y.dtype == yj.dtype and groups.dtype == gj.dtype
        idx = np.flatnonzero(rng.random(900) < 0.7)
        kw = dict(batch_size=32, pos_fraction=0.4, seed=5)
        a = BatchIterator(ShardCache(man), idx, batch_size=32, train=True,
                          sampler=BalancedBatchSampler(y[idx], **kw))
        b = JBatchIterator(JShardCache(man), idx, batch_size=32, train=True,
                           sampler=JBalanced(yj[idx], **kw))
        a.set_epoch(2)
        b.set_epoch(2)
        for x, w in zip(a, b):
            assert sorted(x) == sorted(w)
            for k in x:
                assert np.array_equal(x[k], w[k]), k

    checks = Checks()
    for n, rpg, pos, k in ((600, 1, 0.05, 5), (1500, 4, 0.2, 5), (800, 2, 0.5, 3),
                           (3000, 40, 0.1, 5), (400, 1, 0.3, 2)):
        for seed in (777, 0, 12345):
            checks.run(f"SGKF n={n} rows/group={rpg} pos={pos} k={k} seed={seed}",
                       sgkf, n, rpg, pos, k, seed)
    checks.run("SGKF three classes", sgkf, 900, 3, 0.0, 5, 7, classes=3)
    checks.run("AP, WLL and final_score", metrics)
    checks.run("temperature fit", temperature)
    checks.run("BalancedBatchSampler streams", balanced_sampler)
    checks.run("labels, groups and balanced batches from a cache",
               labels_groups_and_balanced_batches)
    checks.done()
