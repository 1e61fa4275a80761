"""The port's data tools against the JAX package's, on the same inputs:

* the Parquet synth writer (``data/synth.py``): ``make_synth_frame``'s
  columns equal (values and dtypes) at two seeds and non-default
  arguments, and ``write_synth_train_test``'s files equal as tables;
* ``tools.make_synth_data``: the same train / test files;
* ``tools.build_covis_features``: the same two Parquet outputs from one
  config;
* ``tools.check_hash_collisions``: ``unique_buckets_for_m``,
  ``collision_ratio``, ``expected_collision_ratio`` and ``recommend_m``
  equal, and ``audit_column`` (its result and its printout) on an int, a
  string and a float column with NaN;
* ``tools.guess_numeric_types``: ``dim_rule``, ``analyze`` and
  ``suggestions`` equal, and the CLI's ``column_type_report.csv`` and
  ``column_suggestions.yaml`` byte-equal;
* ``tools.blend_submissions``: ``blend`` equal in its three methods and
  weights (frames and printout), the CLI's CSV byte-equal, and mismatched
  IDs refused with ValueError by both.

One test item (see ``_torch_helpers``).
"""

import contextlib
import io
import sys

import numpy as np

from _torch_helpers import Checks

ROWS, TEST_ROWS = 1500, 400


@contextlib.contextmanager
def _argv(args):
    saved = sys.argv
    sys.argv = ["prog"] + list(args)
    try:
        yield
    finally:
        sys.argv = saved


def _printed(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def test_torch_tools_match_jax(tmp_path):
    import pandas as pd
    import pyarrow.parquet as pq
    import yaml

    from tossctr_tpu.data import synth as jsynth
    from tossctr_tpu.tools import blend_submissions as jblend
    from tossctr_tpu.tools import build_covis_features as jbcf
    from tossctr_tpu.tools import check_hash_collisions as jchc
    from tossctr_tpu.tools import guess_numeric_types as jgnt
    from tossctr_tpu.tools import make_synth_data as jmsd
    from tossctr_tpu.utils.hashing import stable_hash64
    from tossctr_tpu_torch.data import synth
    from tossctr_tpu_torch.tools import (blend_submissions, build_covis_features,
                                         check_hash_collisions, guess_numeric_types,
                                         make_synth_data)

    def same_table(a, b):
        ta, tb = pq.read_table(a), pq.read_table(b)
        assert ta.schema == tb.schema and ta.num_rows == tb.num_rows, (a, b)
        for name in ta.column_names:
            x = ta[name].to_numpy(zero_copy_only=False)
            y = tb[name].to_numpy(zero_copy_only=False)
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (a, name)

    def synth_writer():
        for seed, kw in ((0, {}), (9, dict(n_inventory=30, seq_len_max=12, missing_rate=0.4,
                                           id_prefix="X"))):
            a = jsynth.make_synth_frame(300, seed=seed, **kw)
            b = synth.make_synth_frame(300, seed=seed, **kw)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(
                    a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
        ja = jsynth.write_synth_train_test(str(tmp_path / "jsynth"), n_train=ROWS,
                                           n_test=TEST_ROWS, seed=2)
        pt = synth.write_synth_train_test(str(tmp_path / "psynth"), n_train=ROWS,
                                          n_test=TEST_ROWS, seed=2)
        for k in ("train", "test"):
            same_table(ja[k], pt[k])
        assert "clicked" not in pq.read_table(pt["test"]).column_names

    def make_synth_cli():
        args = ["--rows", "700", "--test-rows", "200", "--seed", "3"]
        with _argv(["--out", str(tmp_path / "jmsd")] + args):
            _printed(jmsd.main)
        _printed(make_synth_data.main, ["--out", str(tmp_path / "pmsd")] + args)
        for k in ("train", "test"):
            same_table(tmp_path / "jmsd" / f"{k}.parquet", tmp_path / "pmsd" / f"{k}.parquet")

    def covis_cli():
        for tag in ("jax", "port"):
            d = {"data": {"train_path": str(tmp_path / "jsynth" / "train.parquet"),
                          "test_path": str(tmp_path / "jsynth" / "test.parquet")},
                 "features": {"covis": {"enabled": True, "seq_top_k": 12, "n_folds": 5,
                                        "stream_batch_rows": 600,
                                        "out_dir": str(tmp_path / f"covis_{tag}")}},
                 "cv": {"time_key": "day_of_week", "composite_group": True}}
            (tmp_path / f"covis_{tag}.yaml").write_text(yaml.safe_dump(d))
        with _argv(["--cfg", str(tmp_path / "covis_jax.yaml")]):
            _printed(jbcf.main)
        _printed(build_covis_features.main, ["--cfg", str(tmp_path / "covis_port.yaml")])
        for name in ("rowfeat_oof_all.parquet", "rowfeat_test.parquet"):
            same_table(tmp_path / "covis_jax" / name, tmp_path / "covis_port" / name)

    def hash_collisions():
        rng = np.random.default_rng(0)
        h = stable_hash64(rng.integers(0, 10**7, 5000))
        for m in (1, 11, 1009, 100_003):
            assert jchc.unique_buckets_for_m(h, m) == check_hash_collisions.unique_buckets_for_m(
                h, m)
            assert jchc.collision_ratio(h, m, 5000) == check_hash_collisions.collision_ratio(
                h, m, 5000)
            assert jchc.expected_collision_ratio(5000, m) == \
                check_hash_collisions.expected_collision_ratio(5000, m)
        for n, t in ((10, 0.5), (5000, 0.01), (10**6, 0.001)):
            assert jchc.recommend_m(n, t) == check_hash_collisions.recommend_m(n, t)
        train = str(tmp_path / "jsynth" / "train.parquet")
        for col in ("inventory_id", "gender", "feat_a_1"):
            a = _printed(jchc.audit_column, train, col, [13, 101, 1009], 0.05)
            b = _printed(check_hash_collisions.audit_column, train, col, [13, 101, 1009], 0.05)
            assert a == b, (a, b)

    def numeric_types():
        for n in (0, 1, 50, 10**4, 10**9):
            assert jgnt.dim_rule(n) == guess_numeric_types.dim_rule(n)
        train = str(tmp_path / "jsynth" / "train.parquet")
        a, b = jgnt.analyze(train), guess_numeric_types.analyze(train)
        assert a == b
        assert jgnt.suggestions(a, 0.3) == guess_numeric_types.suggestions(b, 0.3)
        with _argv(["--parquet", train, "--out-dir", str(tmp_path / "jgnt")]):
            _printed(jgnt.main)
        _printed(guess_numeric_types.main, ["--parquet", train, "--out-dir",
                                            str(tmp_path / "pgnt")])
        for name in ("column_type_report.csv", "column_suggestions.yaml"):
            assert (tmp_path / "jgnt" / name).read_bytes() == \
                (tmp_path / "pgnt" / name).read_bytes(), name

    def blend():
        rng = np.random.default_rng(1)
        ids = [f"TEST_{i:08d}" for i in range(400)]
        a = pd.DataFrame({"ID": ids, "clicked": rng.random(400)})
        b = pd.DataFrame({"ID": ids[::-1], "clicked": rng.random(400)})
        b.loc[3, "clicked"] = 0.0  # clipped to 1e-7
        for method in ("mean", "logit_mean", "rank_mean"):
            for w in (0.5, 0.8):
                x = _printed(jblend.blend, a, b, method=method, w=w)
                y = _printed(blend_submissions.blend, a, b, method=method, w=w)
                assert x[1] == y[1]
                pd.testing.assert_frame_equal(x[0], y[0], check_exact=True)
        for fn in (jblend.blend, blend_submissions.blend):
            try:
                fn(a, b.iloc[:-1])
            except ValueError as e:
                assert "ID mismatch" in str(e)
            else:
                raise AssertionError(f"{fn.__module__} blended mismatched IDs")
        a.to_csv(tmp_path / "a.csv", index=False)
        b.to_csv(tmp_path / "b.csv", index=False)
        args = ["--a", str(tmp_path / "a.csv"), "--b", str(tmp_path / "b.csv"),
                "--method", "rank_mean", "--w", "0.3"]
        with _argv(args + ["--out", str(tmp_path / "jblend.csv")]):
            _printed(jblend.main)
        _printed(blend_submissions.main, args + ["--out", str(tmp_path / "pblend.csv")])
        assert (tmp_path / "jblend.csv").read_bytes() == (tmp_path / "pblend.csv").read_bytes()

    checks = Checks()
    checks.run("Parquet synth writer equal", synth_writer)
    checks.run("make_synth_data equal", make_synth_cli)
    checks.run("build_covis_features CLI equal", covis_cli)
    checks.run("check_hash_collisions equal", hash_collisions)
    checks.run("guess_numeric_types equal", numeric_types)
    checks.run("blend_submissions equal, mismatched IDs refused", blend)
    checks.done()
