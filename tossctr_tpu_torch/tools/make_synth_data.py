"""CLI: a synthetic Toss-shaped train/test Parquet pair (port of
``tossctr_tpu/tools/make_synth_data.py``; needs pyarrow):

    python -m tossctr_tpu_torch.tools.make_synth_data --out DIR [--rows N]
        [--test-rows N] [--seed S]

writes ``DIR/train.parquet`` and ``DIR/test.parquet``
(``data/synth.py`` ``write_synth_train_test``), which the Parquet ETL
(``python -m tossctr_tpu_torch.train --build-cache``) turns into a cache.
"""

import argparse


def main(argv=None):
    from tossctr_tpu_torch.data.synth import write_synth_train_test

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--test-rows", type=int, default=4_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    paths = write_synth_train_test(
        args.out, n_train=args.rows, n_test=args.test_rows, seed=args.seed
    )
    print(f"train: {paths['train']}\ntest:  {paths['test']}")


if __name__ == "__main__":
    main()
