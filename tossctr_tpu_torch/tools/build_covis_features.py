"""CLI: the covis out-of-fold row features (port of
``tossctr_tpu/tools/build_covis_features.py``; needs pyarrow and pandas):

    python -m tossctr_tpu_torch.tools.build_covis_features --cfg <cfg>

Wires ``features.covis`` and the cv section into ``CovisConfig`` and runs
folds -> pair stats -> row features on ``data.train_path`` /
``test_path``, writing ``rowfeat_oof_all.parquet`` and
``rowfeat_test.parquet`` into ``features.covis.out_dir`` for the cache
build's covis join.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    args = ap.parse_args(argv)

    from tossctr_tpu_torch.config import load_config
    from tossctr_tpu_torch.features.covis import CovisConfig, build_covis_features

    cfg = load_config(args.cfg)
    ccfg = CovisConfig.from_cfg(cfg)
    out = build_covis_features(cfg.data.train_path, cfg.data.test_path, ccfg)
    for k, v in out.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
