"""The port's data path against the JAX package's, on the same seeded
inputs:

* ``utils/hashing.py``: ``stable_hash64``, ``hash_to_buckets`` and
  ``hash_group_ids`` bit-equal on ints (signed, unsigned, large), floats
  (integral, non-integral, NaN, -0.0, inf), strings (unicode, and longer
  than the U64 cut), objects (None, NaN, mixed types, bools) and the
  composite group x time ids;
* ``tokenize_sequences`` equal, with empty tokens (leading, trailing,
  doubled), None, and rows longer than ``max_len``;
* ``analyze_schema_and_stats`` equal: the column inventory, the exact
  medians (an all-null column among them), with ``remove_cols`` and
  explicit numeric columns;
* ``build_sharded_cache`` byte-equal: every ``.npy`` of every shard (3
  shards: ``shard_rows`` cuts inside stream batches), and
  ``manifest.json`` but its paths; plain, with ``composite_group``, with
  ``hash_buckets_margin``, with ``remove_cols``, with a categorical
  column the Parquet lacks, and with the covis join on train and on test
  (each package joining its own ``build_covis_features`` output);
* the training CLI: ``--build-cache --device cpu`` builds the same caches
  as the JAX package's ``build_train_and_test`` and reaches ``train_main``
  (stubbed: nothing trains); a missing manifest builds too; without
  pyarrow the build raises an ImportError that names it.

One test item (see ``_torch_helpers``).
"""

import contextlib
import json
import os
import sys

import numpy as np

from _torch_helpers import Checks

ROWS, TEST_ROWS = 2500, 700
SHARD_ROWS, STREAM_ROWS = 1000, 700
CATS = ["gender", "age_group", "inventory_id", "hour", "l_feat_1"]


def _hash_inputs():
    rng = np.random.default_rng(0)
    floats = rng.normal(0, 1e3, 64)
    floats[::5] = np.round(floats[::5])
    floats[3], floats[7], floats[11], floats[13] = np.nan, -0.0, np.inf, 1e17
    long = "x" * 70 + "tail"
    return {
        "int64": rng.integers(-2**62, 2**62, 64),
        "int32": rng.integers(-1000, 1000, 64).astype(np.int32),
        "uint64": rng.integers(0, 2**63, 64).astype(np.uint64) * np.uint64(2),
        "float64": floats,
        "float32": floats.astype(np.float32),
        "str": np.array([f"id_{i}" for i in rng.integers(0, 10**6, 64)] + ["", "가나다", long]),
        "object": np.array([None, np.nan, 3.0, 3, "3", 2.5, "abc", True, -7.0, long, "é"],
                           dtype=object),
    }


def _tables(pa):
    """Small Parquet tables for the option cases."""
    rng = np.random.default_rng(3)
    n = 120
    feat = rng.normal(0, 1, n)
    feat[rng.random(n) < 0.3] = np.nan
    return {
        "stats": pa.table({
            "feat_x_1": pa.array([1.0, 2.0, None, 100.0, 7.5]),
            "feat_x_2": pa.array([None] * 5, type=pa.float64()),
            "feat_x_3": pa.array([4.0, 3.0, 2.0, 1.0, 0.0]),
            "other_1": pa.array([1.0, 1.0, 2.0, 3.0, 5.0]),
            "clicked": pa.array([0, 1, 0, 1, 1]),
            "seq": pa.array(["1", "2", "3", "4", "5"]),
        }),
        "options": pa.table({
            "c1": pa.array([str(i % 7) for i in range(n)]),
            "feat_x_1": pa.array(feat),
            "feat_x_2": pa.array(rng.normal(0, 1, n)),
            "seq": pa.array([",".join(map(str, rng.integers(1, 50, rng.integers(0, 9))))
                             for _ in range(n)]),
            "clicked": pa.array(rng.integers(0, 2, n)),
        }),
    }


def _cache_bytes(man_path):
    """{relative file: bytes} of a cache, and its manifest without paths."""
    with open(man_path) as f:
        man = json.load(f)
    root = os.path.dirname(man_path)
    files = {}
    for sh in man["shards"]:
        for k, v in sh.items():
            if isinstance(v, dict) and "path" in v:
                with open(v.pop("path"), "rb") as f:
                    files[f"shard_{sh['index']:03d}/{k}.npy"] = f.read()
    man.pop("parquet")
    assert sorted(files) == sorted(
        os.path.relpath(os.path.join(d, n), root) for d, _, ns in os.walk(root) for n in ns
        if n.endswith(".npy"))
    return files, man


def _same_cache(ma, mb):
    fa, a = _cache_bytes(ma)
    fb, b = _cache_bytes(mb)
    assert a == b, (a, b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k] == fb[k], k
    return a


@contextlib.contextmanager
def _without_pyarrow():
    saved = {m: sys.modules[m] for m in list(sys.modules) if m.split(".")[0] == "pyarrow"}
    for m in saved:
        sys.modules[m] = None
    sys.modules["pyarrow"] = None
    try:
        yield
    finally:
        del sys.modules["pyarrow"]
        for m in saved:
            sys.modules[m] = saved[m]


def test_torch_etl_matches_jax(tmp_path, monkeypatch):
    import pyarrow as pa
    import pyarrow.parquet as pq
    import yaml

    from tossctr_tpu.config import load_config as jax_load_config
    from tossctr_tpu.data import etl as jetl
    from tossctr_tpu.features.covis import CovisConfig as JCovisConfig
    from tossctr_tpu.features.covis import build_covis_features as jax_covis
    from tossctr_tpu.utils import hashing as jhash
    from tossctr_tpu_torch.data import etl
    from tossctr_tpu_torch.data.synth import write_synth_train_test
    from tossctr_tpu_torch.features.covis import CovisConfig, build_covis_features
    from tossctr_tpu_torch.train import __main__ as train_cli
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.utils import hashing

    paths = write_synth_train_test(str(tmp_path / "data"), n_train=ROWS, n_test=TEST_ROWS,
                                   seed=4)
    tables = _tables(pa)
    for name, t in tables.items():
        pq.write_table(t, str(tmp_path / f"{name}.parquet"))
    common = dict(seq_col="seq", cat_cols=CATS, hash_buckets={"gender": 17, "inventory_id": 301},
                  hash_buckets_margin=0, num_patterns=["feat_*", "history_*"], max_len=24,
                  pad_id=0, group_key="inventory_id", shard_rows=SHARD_ROWS,
                  stream_batch_rows=STREAM_ROWS)

    def build_both(tag, parquet, is_train=True, **over):
        kw = dict(common, is_train=is_train, target_col="clicked" if is_train else None)
        kw.update(over)
        ja = jetl.build_sharded_cache(parquet, str(tmp_path / "jax" / tag), **kw)
        if "covis_dir" in over:
            kw["covis_dir"] = over["covis_dir"].replace("covis_jax", "covis_port")
        pt = etl.build_sharded_cache(parquet, str(tmp_path / "port" / tag), **kw)
        return _same_cache(ja, pt)

    def hashes():
        for name, v in _hash_inputs().items():
            a, b = jhash.stable_hash64(v), hashing.stable_hash64(v)
            assert a.dtype == b.dtype == np.uint64 and np.array_equal(a, b), name
            for seed in (0, 2025, 7):
                assert np.array_equal(jhash.stable_hash64(v, seed), hashing.stable_hash64(v, seed))
            for m in (1, 10, 1_000_003):
                a, b = jhash.hash_to_buckets(v, m), hashing.hash_to_buckets(v, m)
                assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), (name, m)
            a, b = jhash.hash_group_ids(v), hashing.hash_group_ids(v)
            assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b), name
        inp = _hash_inputs()
        for g, t in (("int64", "int32"), ("str", "str"), ("object", "object")):
            n = min(len(inp[g]), len(inp[t]))
            a = jhash.hash_group_ids(inp[g][:n], inp[t][::-1][:n], seed=11)
            b = hashing.hash_group_ids(inp[g][:n], inp[t][::-1][:n], seed=11)
            assert np.array_equal(a, b), (g, t)
        # the string forms behind them, the U32 / U64 cuts included
        for v in inp.values():
            a, b = jhash._to_utf8_strings(v), hashing._to_utf8_strings(v)
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def tokenize():
        rng = np.random.default_rng(1)
        rows = []
        for _ in range(300):
            toks = [str(int(t)) for t in rng.integers(1, 10**6, rng.integers(0, 40))]
            toks = ["" if rng.random() < 0.1 else t for t in toks]
            rows.append(",".join(toks))
        rows += ["1,,2", "5,7,", ",3", ",,9,,", "", None, "1,2,,3,4,5"]
        s = np.array(rows, dtype=object)
        for max_len in (1, 4, 16, 32):
            a = jetl.tokenize_sequences(s, max_len, pad_id=0)
            b = etl.tokenize_sequences(s, max_len, pad_id=0)
            assert a.dtype == b.dtype and np.array_equal(a, b), max_len
        assert np.array_equal(jetl.tokenize_sequences(s[:0], 8), etl.tokenize_sequences(s[:0], 8))

    def schema_stats():
        cases = [
            (str(tmp_path / "stats.parquet"), "clicked", "seq", [], ["feat_*"], "g", "median",
             None, None),
            (str(tmp_path / "stats.parquet"), None, "seq", [], ["feat_*", "other_*"], "g",
             "median", None, ["feat_x_3"]),
            (str(tmp_path / "stats.parquet"), "clicked", "seq", [], ["feat_*"], "g", "zero",
             None, None),
            (str(tmp_path / "stats.parquet"), "clicked", "seq", [], [], "g", "median",
             ["feat_x_3", "missing", "feat_x_1"], None),
            (paths["train"], "clicked", "seq", CATS, ["feat_*", "history_*", "l_feat_*"],
             "inventory_id", "median", None, ["history_a_2"]),
        ]
        for case in cases:
            a = jetl.analyze_schema_and_stats(*case)
            b = etl.analyze_schema_and_stats(*case)
            assert a == b, (case, a, b)
        assert b["med_map"]["history_a_1"] == float(np.nanmedian(
            pq.read_table(paths["train"])["history_a_1"].to_numpy(zero_copy_only=False)))
        assert etl._match_patterns(["a_1", "b", "a_2", "a_1"], ["a_*", "b"]) == \
            jetl._match_patterns(["a_1", "b", "a_2", "a_1"], ["a_*", "b"])

    def plain_cache():
        man = build_both("plain", paths["train"])
        assert [s["rows"] for s in man["shards"]] == [1000, 1000, 500]
        build_both("plain_test", paths["test"], is_train=False)

    def composite_group():
        build_both("composite", paths["train"], time_key="day_of_week", composite_group=True)

    def margin():
        man = build_both("margin", str(tmp_path / "options.parquet"), cat_cols=["c1"],
                         hash_buckets={"c1": 10}, hash_buckets_margin=500, group_key="c1",
                         num_patterns=["feat_*"], shard_rows=50, stream_batch_rows=35)
        assert len(man["shards"]) == 3

    def remove_cols():
        man = build_both("remove", str(tmp_path / "options.parquet"), cat_cols=["c1"],
                         num_patterns=["feat_*"], remove_cols=["feat_x_2", "c1"],
                         shard_rows=50, stream_batch_rows=35)
        assert man["num_cols"] == ["feat_x_1"]

    def missing_cat():
        build_both("ghost", str(tmp_path / "options.parquet"), cat_cols=["ghost", "c1"],
                   num_patterns=["feat_*"], shard_rows=50, stream_batch_rows=35)

    def covis_join():
        kw = dict(targets=["inventory_id"], seq_top_k=16, recency_tau=32.0, prior_strength=20.0,
                  min_impr=5, n_folds=5, group_key="inventory_id", time_key="day_of_week",
                  composite_group=True, stream_batch_rows=900)
        jax_covis(paths["train"], paths["test"],
                  JCovisConfig(out_dir=str(tmp_path / "covis_jax"), **kw))
        build_covis_features(paths["train"], paths["test"],
                             CovisConfig(out_dir=str(tmp_path / "covis_port"), **kw))
        man = build_both("covis_train", paths["train"], covis_dir=str(tmp_path / "covis_jax"))
        assert len(man["num_cols"]) == 10 + 8 and man["num_cols"][-1].startswith("covis_")
        build_both("covis_test", paths["test"], is_train=False,
                   covis_dir=str(tmp_path / "covis_jax"))

    def cli():
        d = {
            "exp_name": "etl_cli",
            "data": {"train_path": paths["train"], "test_path": paths["test"],
                     "cache_dir": str(tmp_path / "cli_port"), "cat_cols": CATS,
                     "hash_buckets": {"gender": 17, "inventory_id": 301},
                     "num_patterns": ["feat_*"], "shard_rows": SHARD_ROWS,
                     "stream_batch_rows": STREAM_ROWS},
            "sequence": {"max_len": 16},
            "cv": {"time_key": "day_of_week", "composite_group": True},
            "logging": {"log_dir": str(tmp_path / "runs")},
        }
        cfg_port = tmp_path / "cli_port.yaml"
        cfg_port.write_text(yaml.safe_dump(d))
        d["data"]["cache_dir"] = str(tmp_path / "cli_jax")
        cfg_jax = tmp_path / "cli_jax.yaml"
        cfg_jax.write_text(yaml.safe_dump(d))
        mp_tr, mp_te = jetl.build_train_and_test(jax_load_config(str(cfg_jax)))
        calls = []
        monkeypatch.setattr(trainer, "train_main",
                            lambda cfg, device: calls.append((cfg.data.cache_dir, str(device)))
                            or str(tmp_path / "runs"))
        train_cli.main(["--cfg", str(cfg_port), "--build-cache", "--device", "cpu"])
        assert calls == [(str(tmp_path / "cli_port"), "cpu")], calls
        _same_cache(mp_tr, str(tmp_path / "cli_port" / "train" / "manifest.json"))
        _same_cache(mp_te, str(tmp_path / "cli_port" / "test" / "manifest.json"))
        # a missing manifest builds without --build-cache
        d["data"]["cache_dir"] = str(tmp_path / "cli_missing")
        cfg_missing = tmp_path / "cli_missing.yaml"
        cfg_missing.write_text(yaml.safe_dump(d))
        train_cli.main(["--cfg", str(cfg_missing), "--device", "cpu"])
        assert calls[-1] == (str(tmp_path / "cli_missing"), "cpu")
        _same_cache(mp_tr, str(tmp_path / "cli_missing" / "train" / "manifest.json"))
        # and an existing one is kept
        train_cli.main(["--cfg", str(cfg_missing), "--device", "cpu"])
        assert len(calls) == 3
        # without pyarrow the build names it
        d["data"]["cache_dir"] = str(tmp_path / "cli_no_arrow")
        cfg_no_arrow = tmp_path / "cli_no_arrow.yaml"
        cfg_no_arrow.write_text(yaml.safe_dump(d))
        with _without_pyarrow():
            try:
                train_cli.main(["--cfg", str(cfg_no_arrow), "--build-cache", "--device", "cpu"])
            except ImportError as e:
                assert "pyarrow" in str(e), e
            else:
                raise AssertionError("the build ran without pyarrow")
        assert len(calls) == 3
        assert not os.path.exists(tmp_path / "cli_no_arrow" / "train" / "manifest.json")

    checks = Checks()
    checks.run("stable hashes bit-equal", hashes)
    checks.run("tokenize_sequences equal", tokenize)
    checks.run("analyze_schema_and_stats equal", schema_stats)
    checks.run("plain caches byte-equal", plain_cache)
    checks.run("composite_group cache byte-equal", composite_group)
    checks.run("hash_buckets_margin cache byte-equal", margin)
    checks.run("remove_cols cache byte-equal", remove_cols)
    checks.run("missing categorical column cache byte-equal", missing_cat)
    checks.run("covis-joined caches byte-equal", covis_join)
    checks.run("train --build-cache", cli)
    checks.done()
