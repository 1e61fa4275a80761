"""The port's config schema and model spec against the JAX package's:
every file of ``cfgs/`` loads to the same mapping, the flagship config
built in code is ``cfgs/dare_qnn_next_tpu.yaml``, ``compute_dtype``
maps amp to torch dtypes, and the flagship model spec (column groups,
QNN blocks, 200 features) matches; ``synth_small_config_dict`` is
``cfgs/synth_small.yaml``.  Which configs the port takes: 8 of
the 9 files pass ``train.trainer._check_ported`` and
``models.build_model``'s check (``synth_small.yaml`` with its dense-mode
AdamW tables among them); ``pod_scale_stretch.yaml`` asks for more than
one device and is refused, naming ROADMAP queue 1 item 8.  One test item
(see ``_torch_helpers``)."""

import glob
import os

import pytest

from _torch_helpers import Checks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "cfgs", "dare_qnn_next_tpu.yaml")
# the configs the port refuses, and what the refusal names
REFUSED = {"pod_scale_stretch.yaml": "more than one device, ROADMAP queue 1 item 8"}


def test_config_and_spec_match_jax():
    import torch
    import yaml

    from tossctr_tpu.config import load_config as jax_load_config
    from tossctr_tpu.models.ctr_model import build_model_spec as jax_build_model_spec
    from tossctr_tpu_torch.config import Config, load_config
    from tossctr_tpu_torch.config.flagship import (
        flagship_config_dict,
        synth_small_config_dict,
        v3_k120_config_dict,
        v3_k148_config_dict,
    )
    from tossctr_tpu_torch.config.schema import deep_merge, load_yaml_with_base
    from tossctr_tpu_torch.models.ctr_model import build_model_spec

    def loads_as_in_the_jax_package(path):
        assert load_config(path).to_dict() == jax_load_config(path).to_dict()

    def flagship_dict_is_the_yaml_file():
        with open(FLAGSHIP) as f:
            assert flagship_config_dict() == yaml.safe_load(f)

    def synth_small_dict_is_the_yaml_file():
        with open(os.path.join(ROOT, "cfgs", "synth_small.yaml")) as f:
            assert synth_small_config_dict() == yaml.safe_load(f)

    def v3_k120_dict_is_the_yaml_file_over_its_base():
        """Also v3_k148, whose base is v3_k120."""
        for name, fn, want in (("v3_k120_s1_tpu", v3_k120_config_dict, (120, 4, 8192)),
                               ("v3_k148_s1_tpu", v3_k148_config_dict, (148, 4, 4096))):
            path = os.path.join(os.path.dirname(FLAGSHIP), f"{name}.yaml")
            assert fn() == load_yaml_with_base(path), name
            cfg = Config.from_dict(fn())
            got = (cfg.sequence.top_k, cfg.sequence.tfm.n_layers, cfg.train.batch_size)
            assert got == want, (name, got)

    def compute_dtype():
        for amp, want in (("bf16", torch.bfloat16), ("fp16", torch.bfloat16),
                          ("none", torch.float32)):
            assert Config.from_dict({"amp": amp}).compute_dtype == want

    def deep_merge_and_buckets():
        merged = deep_merge({"a": {"b": 1, "c": 2}, "d": 3}, {"a": {"b": 5, "c": None}, "e": 1})
        assert merged == {"a": {"b": 5}, "d": 3, "e": 1}
        cfg = Config.from_dict({"data": {"hash_buckets": {"x": 10}, "hash_buckets_margin": 2,
                                         "default_hash_bucket": 7}})
        assert cfg.data.bucket_for("x") == 12 and cfg.data.bucket_for("y") == 9

    def flagship_model_spec_matches():
        dims = {"X_num": 82, "X_mask": 82, "X_cat": 35, "seq_len": 400}
        got = build_model_spec(load_config(FLAGSHIP), dims)
        want = jax_build_model_spec(jax_load_config(FLAGSHIP), dims)
        assert got.n_feat == want.n_feat == 200

        def groups(spec):
            return [(g.d_in, g.cols, g.col_idx, g.cards, g.offsets) for g in spec.cat_groups]

        assert groups(got) == groups(want)
        assert got.block_slices == want.block_slices
        for name in ("emb_dim", "f_embed", "seq_vocab", "top_k", "recency_tau", "query_mode",
                     "tfm_n_layers", "tfm_n_heads", "tfm_ffn_hidden", "table_dtype",
                     "select_chunk", "select_proxy_block", "select_proxy_candidates"):
            assert getattr(got, name) == getattr(want, name), name
        assert {k: want.qnn[k] for k in got.qnn} == got.qnn

    def ported_or_refused(path):
        """A config the port takes passes the checks; the one it does not
        raises NotImplementedError naming its ROADMAP item."""
        from tossctr_tpu_torch.models import build_model
        from tossctr_tpu_torch.train.trainer import _check_ported

        cfg = load_config(path)
        if os.path.basename(path) in REFUSED:
            with pytest.raises(NotImplementedError, match=REFUSED[os.path.basename(path)]):
                _check_ported(cfg)
            return
        _check_ported(cfg)
        # the check, without allocating the tables
        build_model(cfg, {"X_num": 3, "X_mask": 3, "X_cat": len(cfg.data.cat_cols),
                          "seq_len": cfg.sequence.max_len}, device="meta")

    checks = Checks()
    paths = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yaml")))
    assert len(paths) == 9
    for path in paths:
        checks.run(f"loads {os.path.basename(path)}", loads_as_in_the_jax_package, path)
        checks.run(f"ported or refused: {os.path.basename(path)}", ported_or_refused, path)
    for fn in (flagship_dict_is_the_yaml_file, synth_small_dict_is_the_yaml_file,
               v3_k120_dict_is_the_yaml_file_over_its_base,
               compute_dtype, deep_merge_and_buckets, flagship_model_spec_matches):
        checks.run(fn.__name__, fn)
    checks.done()
