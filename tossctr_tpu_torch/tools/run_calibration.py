"""Out-of-fold calibration.

Port of ``tossctr_tpu/tools/run_calibration.py``:

    python -m tossctr_tpu_torch.tools.run_calibration --cfg <cfg> [--device cpu]
        [--method temperature|isotonic|temperature+isotonic]
        [--oof-z oof_z.npy --oof-y oof_y.npy] [--out-dir DIR]

Either takes precomputed out-of-fold logits and labels (``--oof-z`` /
``--oof-y``), or replays them: the trainer's split exactly
(``max(5, cv.n_splits)`` folds of the stratified group K-fold, shuffled,
the config's seed; ``train/cv_split.py``), each complete fold checkpoint
(its EMA weights where it has them) run over its validation rows on the
device, and a NaN sentinel that finds any row no fold filled.  A run
with fewer complete folds, or ``cv.n_splits: 1``, calibrates on the
rows it covers.  It fits a ``Calibrator``, prints AP / WLL / Score
before and after, and writes into the experiment directory (or
``--out-dir``) ``cal_meta.json``, ``oof_metrics.json`` and
``calibrator.json``, the port's calibrator file: copied into a fold's
``ckpt_folds_<f>/``, serving (``python -m tossctr_tpu_torch.infer``)
applies it to that fold.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def compute_oof_from_ckpts(cfg, manifest_path: str, exp_dir: str, device="cuda"):
    """-> (z, y, rows covered, rows in the cache): the out-of-fold logits of
    the complete fold checkpoints under ``exp_dir``."""
    from ..data.dataset import ShardCache
    from ..data.loader import BatchIterator
    from ..models.ctr_model import build_model, resolve_device
    from ..train.checkpoint import fold_ckpt_dir, load_fold_checkpoint
    from ..train.cv_split import StratifiedGroupKFold
    from ..train.trainer import make_eval_step, run_validation

    dev = resolve_device(device)
    cache = ShardCache(manifest_path)
    y = cache.labels()
    groups = cache.groups()
    n = y.shape[0]
    z_oof = np.full(n, np.nan, np.float64)

    n_splits = int(cfg.cv.n_splits)
    effective = max(5, n_splits)
    sgkf = StratifiedGroupKFold(n_splits=effective, shuffle=True, random_state=cfg.seed)
    model = build_model(cfg, cache.dims, dev)
    eval_step = make_eval_step(model)

    folds_done = 0
    for fold, (_, va) in enumerate(sgkf.split(np.zeros_like(y), y, groups)):
        d = fold_ckpt_dir(exp_dir, fold)
        if not os.path.exists(os.path.join(d, "meta.json")):
            continue
        ckpt = load_fold_checkpoint(d)
        model.load_state_dict(ckpt["ema"] if ckpt.get("ema") is not None else ckpt["params"],
                              strict=True)
        loader = BatchIterator(cache, va, batch_size=cfg.train.batch_size, train=True,
                               shuffle=False, drop_last=False)
        _, _, z = run_validation(eval_step, model.state_dict(), loader, dev)
        z_oof[va] = z.cpu().numpy()
        folds_done += 1

    filled = ~np.isnan(z_oof)
    if n_splits == 1 or folds_done < effective:
        # partial-fold runs calibrate on the covered subset
        return z_oof[filled], y[filled].astype(np.int32), int(filled.sum()), n
    if not filled.all():
        raise RuntimeError(f"OOF incomplete: {int((~filled).sum())} rows unfilled")
    return z_oof, y.astype(np.int32), n, n


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True, help="YAML (PyYAML) or JSON config")
    ap.add_argument("--oof-z", default=None, help="precomputed OOF logits .npy")
    ap.add_argument("--oof-y", default=None, help="precomputed OOF labels .npy")
    ap.add_argument("--method", default=None, help="override calibration.method")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..eval.calibration import Calibrator
    from ..eval.metrics import final_score

    cfg = load_config(args.cfg)
    exp_dir = cfg.exp_dir()
    out_dir = args.out_dir or exp_dir
    os.makedirs(out_dir, exist_ok=True)

    if args.oof_z and args.oof_y:
        z = np.load(args.oof_z)
        y = np.load(args.oof_y).astype(np.int32)
        covered, total = len(z), len(z)
    else:
        manifest = cfg.data.manifest_train or os.path.join(cfg.data.cache_dir, "train",
                                                           "manifest.json")
        z, y, covered, total = compute_oof_from_ckpts(cfg, manifest, exp_dir, args.device)
    print(f"OOF rows: {covered}/{total}")

    p_raw = 1 / (1 + np.exp(-np.clip(z, -50, 50)))
    ap0, wll0, s0 = final_score(y, p_raw, formula=cfg.eval.score_formula)
    c = cfg.calibration
    cal = Calibrator(method=args.method or c.method, lr=c.lr, iters=c.iters, clamp_T=c.clamp_T,
                     l2_reg=c.l2_reg, min_iso_nodes=c.min_iso_nodes).fit(z, y)
    ap1, wll1, s1 = final_score(y, cal.predict_proba(z), formula=cfg.eval.score_formula)
    print(f"before: AP={ap0:.6f} WLL={wll0:.6f} Score={s0:.6f}")
    print(f"after:  AP={ap1:.6f} WLL={wll1:.6f} Score={s1:.6f}")

    with open(os.path.join(out_dir, "cal_meta.json"), "w") as f:
        json.dump(cal.meta(), f, indent=2)
    with open(os.path.join(out_dir, "oof_metrics.json"), "w") as f:
        json.dump({"rows": int(covered), "total": int(total),
                   "before": {"AP": ap0, "WLL": wll0, "Score": s0},
                   "after": {"AP": ap1, "WLL": wll1, "Score": s1}}, f, indent=2)
    with open(os.path.join(out_dir, "calibrator.json"), "w") as f:
        json.dump(cal.to_json(), f)
    print(f"wrote cal_meta.json / oof_metrics.json / calibrator.json to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
