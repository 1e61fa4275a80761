"""CLI: ``python -m tossctr_tpu_torch.train --cfg cfgs/<exp>.yaml``
(counterpart of ``python -m tossctr_tpu.train``): K-fold training on an
existing shard cache into
``<log_dir>/<exp_name>/ckpt_folds_<f>/``, which
``python -m tossctr_tpu_torch.infer`` serves.  Runs on the CUDA card;
``--device cpu`` runs the plain PyTorch path.  ``--cfg`` takes a YAML
file (PyYAML) or a JSON one."""

import argparse
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--build-cache", action="store_true",
                    help="build the shard cache from the Parquet files first (not ported)")
    args = ap.parse_args()

    from tossctr_tpu_torch.config import load_config
    from tossctr_tpu_torch.train.trainer import train_main

    cfg = load_config(args.cfg)
    manifest = cfg.data.manifest_train or os.path.join(cfg.data.cache_dir, "train",
                                                       "manifest.json")
    if args.build_cache or not os.path.exists(manifest):
        # the JAX CLI builds a missing cache with its ETL
        raise NotImplementedError(
            f"not ported to tossctr_tpu_torch yet: building the shard cache {manifest} (the "
            "Parquet ETL needs pyarrow, ROADMAP queue 1 item 6); build it with "
            "python -m tossctr_tpu.train --build-cache, or write a synthetic one with "
            "tossctr_tpu_torch.data.synth")
    exp_dir = train_main(cfg, device=args.device)
    print(f"[train] fold checkpoints under {exp_dir}")


if __name__ == "__main__":
    main()
