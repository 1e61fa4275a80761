"""The port's covis features (``features/covis.py``) against the JAX
package's, on the same seeded Parquet pair:

* ``make_folds`` equal on hashed groups and on a hand-made case;
  ``CovisConfig.from_cfg`` equal on a config with a ``features.covis``
  section (keys that are not fields, such as ``enabled``, ignored by both);
* ``build_covis_features``' two outputs (``rowfeat_oof_all.parquet``,
  ``rowfeat_test.parquet``) equal column by column, exactly: the same
  pandas and NumPy operations on the same data, with the composite group
  x time folds and with a time bin; ``CovisJoiner`` returns the same
  features for train row ids and test IDs;
* the features do not depend on ``stream_batch_rows`` (exactly equal at
  a batch of 1,000,000 rows);
* the out-of-fold leakage guard of ``tests/test_covis.py``: every row
  gets a fold and every fold has rows; and with plain inventory grouping,
  where a (token, inventory) pair never appears outside its own fold,
  every out-of-fold inventory feature is 0 while the test features
  (from the full table) are not.

One test item (see ``_torch_helpers``).
"""

import dataclasses

import numpy as np

from _torch_helpers import Checks

ROWS, TEST_ROWS = 2500, 600


def _equal_frames(a, b):
    assert list(a.columns) == list(b.columns), (list(a.columns), list(b.columns))
    assert len(a) == len(b)
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        assert x.dtype == y.dtype, c
        if x.dtype.kind == "f":
            assert np.array_equal(x, y, equal_nan=True), c
        else:
            assert (x == y).all(), c


def test_torch_covis_matches_jax(tmp_path):
    import pandas as pd
    import pyarrow.dataset as ds

    from tossctr_tpu.config import Config as JConfig
    from tossctr_tpu.features import covis as jcovis
    from tossctr_tpu.utils.hashing import hash_group_ids
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data.synth import write_synth_train_test
    from tossctr_tpu_torch.features import covis

    paths = write_synth_train_test(str(tmp_path / "data"), n_train=ROWS, n_test=TEST_ROWS,
                                   seed=5)
    base = dict(targets=["inventory_id", "age_group"], seq_top_k=16, recency_tau=32.0,
                prior_strength=20.0, min_impr=5, n_folds=5, group_key="inventory_id",
                time_key="day_of_week", composite_group=True, stream_batch_rows=900)
    built = {}

    def build(tag, **over):
        kw = dict(base, **over)
        ja = jcovis.build_covis_features(
            paths["train"], paths["test"],
            jcovis.CovisConfig(out_dir=str(tmp_path / f"jax_{tag}"), **kw))
        pt = covis.build_covis_features(
            paths["train"], paths["test"],
            covis.CovisConfig(out_dir=str(tmp_path / f"port_{tag}"), **kw))
        assert sorted(ja) == sorted(pt) == ["oof", "test"]
        built[tag] = {k: (pd.read_parquet(ja[k]), pd.read_parquet(pt[k])) for k in ja}
        return built[tag]

    def folds():
        inv = ds.dataset(paths["train"], format="parquet").to_table(
            columns=["inventory_id"])["inventory_id"].to_numpy(zero_copy_only=False)
        g = hash_group_ids(inv)
        for n in (2, 5, 7):
            a, b = jcovis.make_folds(g, n), covis.make_folds(g, n)
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        small = np.array([10, 10, 30, 20, 30, 40])
        assert np.array_equal(jcovis.make_folds(small, 3), covis.make_folds(small, 3))
        assert covis.make_folds(small, 3).tolist() == [0, 0, 2, 1, 2, 0]

    def from_cfg():
        d = {"features": {"covis": {"enabled": True, "work_dir": "x", "target_keys": ["a"],
                                    "targets": ["inventory_id"], "seq_top_k": 40,
                                    "out_dir": "/tmp/c"}},
             "cv": {"n_splits": 3, "time_key": "day_of_week", "composite_group": True}}
        a = jcovis.CovisConfig.from_cfg(JConfig.from_dict(d))
        b = covis.CovisConfig.from_cfg(Config.from_dict(d))
        assert dataclasses.asdict(a) == dataclasses.asdict(b), (a, b)
        assert b.n_folds == 5 and b.seq_top_k == 40

    def outputs_equal():
        out = build("composite")
        for k, (a, b) in out.items():
            _equal_frames(a, b)
        assert out["oof"][1].shape == (ROWS, 1 + 16)
        assert out["test"][1].shape == (TEST_ROWS, 1 + 16)
        assert (out["oof"][1].drop(columns="rid").to_numpy() != 0).any()
        for k, (a, b) in build("time_bin", time_bin="hour", targets=["inventory_id"]).items():
            _equal_frames(a, b)

    def joiner():
        for is_train in (True, False):
            ja = jcovis.CovisJoiner(str(tmp_path / "jax_composite"), is_train=is_train)
            pt = covis.CovisJoiner(str(tmp_path / "port_composite"), is_train=is_train)
            assert ja.feature_names == pt.feature_names
            ids = np.array(["TEST_00000003", "TEST_00000001", "nope"], dtype="U64")
            for rid_base, n in ((0, 40), (777, 100), (ROWS - 10, 10)):
                a = ja.features_for(rid_base=rid_base, n=n, ids=ids)
                b = pt.features_for(rid_base=rid_base, n=n, ids=ids)
                assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)

    def batch_invariance():
        ref = built.get("composite") or build("composite")
        big = covis.build_covis_features(
            paths["train"], paths["test"],
            covis.CovisConfig(out_dir=str(tmp_path / "port_big"),
                              **dict(base, stream_batch_rows=1_000_000)))
        for k in ("oof", "test"):
            _equal_frames(ref[k][1], pd.read_parquet(big[k]))

    def leakage_guard():
        inv = ds.dataset(paths["train"], format="parquet").to_table(
            columns=["inventory_id"])["inventory_id"].to_numpy(zero_copy_only=False)
        f = covis.make_folds(hash_group_ids(inv), 5)
        assert len(np.unique(f)) == 5
        assert len(built["composite"]["oof"][1]) == len(f)
        out = build("plain", composite_group=False, time_key=None, targets=["inventory_id"])
        for k, (a, b) in out.items():
            _equal_frames(a, b)
        oof = out["oof"][1].drop(columns="rid").to_numpy()
        test = out["test"][1].drop(columns="ID").to_numpy()
        assert (oof == 0).all(), np.abs(oof).max()
        assert (test != 0).any()

    checks = Checks()
    checks.run("make_folds equal", folds)
    checks.run("CovisConfig.from_cfg equal", from_cfg)
    checks.run("build_covis_features outputs equal", outputs_equal)
    checks.run("CovisJoiner equal", joiner)
    checks.run("stream_batch_rows invariance", batch_invariance)
    checks.run("out-of-fold leakage guard", leakage_guard)
    checks.done()
