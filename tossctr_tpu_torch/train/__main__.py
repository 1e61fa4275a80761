"""CLI: ``python -m tossctr_tpu_torch.train --cfg cfgs/<exp>.yaml``
(counterpart of ``python -m tossctr_tpu.train``): K-fold training on the
shard cache into ``<log_dir>/<exp_name>/ckpt_folds_<f>/``, which
``python -m tossctr_tpu_torch.infer`` serves.  Runs on the CUDA card;
``--device cpu`` runs the plain PyTorch path.  ``--cfg`` takes a YAML
file (PyYAML) or a JSON one.

``--build-cache``, or a missing train manifest, first runs the Parquet
ETL (``data/etl.py`` ``build_train_and_test``: ``data.train_path`` and
``test_path`` into ``data.cache_dir``/{train,test}, with the covis join
when ``features.covis.out_dir`` is set).  The ETL needs pyarrow and
pandas on the host; the device is resolved before it starts, so a run
without a card and without ``--device cpu`` fails at once."""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--build-cache", action="store_true",
                    help="build the shard cache from the Parquet files first")
    args = ap.parse_args(argv)

    from tossctr_tpu_torch.config import load_config
    from tossctr_tpu_torch.models.ctr_model import resolve_device
    from tossctr_tpu_torch.train.trainer import train_main

    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    manifest = cfg.data.manifest_train or os.path.join(cfg.data.cache_dir, "train",
                                                       "manifest.json")
    if args.build_cache or not os.path.exists(manifest):
        from tossctr_tpu_torch.data.etl import build_train_and_test

        print(f"[etl] building shard cache under {cfg.data.cache_dir}")
        mp_tr, mp_te = build_train_and_test(cfg)
        print(f"[etl] train manifest: {mp_tr}\n[etl] test manifest:  {mp_te}")
    exp_dir = train_main(cfg, device=device)
    print(f"[train] fold checkpoints under {exp_dir}")


if __name__ == "__main__":
    main()
