"""The port's ``sweep_rows_add`` plain version and its sweep AdaGrad step
(``rowwise_adagrad_sweep_update``) against
``tossctr_tpu/ops/pallas_scatter.py``
(the Pallas sweep in interpret mode, superblock 512), on a table of V =
5,000 rows (not a multiple of the superblock) and N = 1,200 update rows
with duplicates, one id hot across five of the Pallas kernel's 128-row
chunks, and out-of-range ids (dropped by both), on one and on two tables.

* fp32 tables: within 2e-5 of the largest magnitude.  The Pallas kernel
  merges fp32 deltas through two bf16 one-hot matmul passes (hi and lo
  halves, ``pallas_scatter.py:138-148``), about bf16^2 relative.
* bf16 tables: both sum a row's duplicates in fp32 and round the row
  once, but the one-hot matmul adds them in another order than the plain
  version's sequential sum, so a row may land one bf16 ulp away; the
  rows are held to one ulp of each element, and the untouched rows must
  be bit-equal.
* the sweep AdaGrad step against ``rowwise_adagrad_sweep_update`` (the
  lane-fused table with two accumulator halves, weight decay, the pad
  row among the ids): the
  tables as above, the accumulators within 1e-6 of their largest, the
  pad row unchanged.

One test item (see ``_torch_helpers``).
"""

import numpy as np

from _torch_helpers import Checks, torch_threads

V, N, SUPERBLOCK, HOT, PAD = 5000, 1200, 512, 77, 0


def update_ids(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, N).astype(np.int32)
    ids[rng.permutation(N)[:600]] = HOT  # 600 occurrences: five 128-row chunks
    ids[rng.permutation(N)[:40]] = rng.integers(0, 30, 40)  # duplicates
    ids[:4] = (-1, V, V + 100, -7)  # out of range: dropped
    return ids


def test_sweep_plain_version_matches_pallas():
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import torch

    from tossctr_tpu.ops.pallas_scatter import rowwise_adagrad_sweep_update as jax_update
    from tossctr_tpu.ops.pallas_scatter import sweep_rows_add as jax_sweep
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts, sweep_rows_add
    from tossctr_tpu_torch.train.sparse_embed import (
        RowwiseAdagradState,
        rowwise_adagrad_sweep_update,
    )

    def tables_of(seed, n, D, dtype):
        rng = np.random.default_rng(seed)
        ts = [rng.normal(0, 1, (V, D)).astype(np.float32) for _ in range(n)]
        if dtype == "bf16":
            ts = [t.astype(ml_dtypes.bfloat16).astype(np.float32) for t in ts]
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                            torch.float32)
        # the port's tables are copies: on the CPU ``jnp.asarray`` may alias
        # the numpy array, and the port updates its tables in place while
        # JAX's asynchronously dispatched update may still be reading them
        return ts, [jnp.asarray(t, jdt) for t in ts], [torch.from_numpy(t.copy()).to(tdt)
                                                       for t in ts]

    def hold(name, dtype, got, want, before):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "f32":
            err = float(np.abs(got - want).max())
            assert err <= 2e-5 * float(np.abs(want).max()), f"{name}: {err}"
            return
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        bad = np.abs(got - want) > ulp
        assert not bad.any(), f"{name}: {int(bad.sum())} elements beyond one ulp"
        same = np.all(want == before, axis=1)  # rows no update reached
        assert np.array_equal(got[same], before[same]), f"{name}: an untouched row moved"

    def rows_add(dtype, n_tables, D):
        ids = update_ids(n_tables)
        before, jts, tts = tables_of(D, n_tables, D, dtype)
        rng = np.random.default_rng(D + 1)
        deltas = [rng.normal(0, 0.1, (N, D)).astype(np.float32) for _ in range(n_tables)]
        want = jax_sweep(jts, jnp.asarray(ids), [jnp.asarray(d) for d in deltas],
                         superblock=SUPERBLOCK, interpret=True)
        reset_launch_counts()
        got = sweep_rows_add(tts, torch.from_numpy(ids), [torch.from_numpy(d) for d in deltas])
        assert not any(launch_counts().values())  # CPU: the plain version, in place
        for t, (g, w, b) in enumerate(zip(got, want, before)):
            assert g is tts[t]
            hold(f"table {t}", dtype, g, w, b)

    def adagrad(dtype):
        ids = update_ids(9)
        ids[::11] = PAD
        before, jts, tts = tables_of(5, 1, 128, dtype)
        rng = np.random.default_rng(6)
        g = rng.normal(0, 0.3, (N, 128)).astype(np.float32)
        acc = rng.uniform(0, 0.5, (V, 2)).astype(np.float32)
        ids_ok = np.where((ids >= 0) & (ids < V), ids, PAD)  # the step's ids are in range
        (jt,), (ja,) = jax_update(jts, [jnp.asarray(acc)], jnp.asarray(ids_ok), [jnp.asarray(g)],
                                  lr=0.05, weight_decay=0.01, pad_row=PAD,
                                  superblock=SUPERBLOCK, interpret=True, halves=2)
        (tt,), state = tts, RowwiseAdagradState(torch.from_numpy(acc.copy()))
        rowwise_adagrad_sweep_update([tt], [state], torch.from_numpy(ids_ok),
                                     [torch.from_numpy(g)], lr=0.05, weight_decay=0.01,
                                     pad_row=PAD)
        ta = state.accum
        hold("table", dtype, tt, jt, before[0])
        err = float(np.abs(ta.numpy() - np.asarray(ja)).max())
        assert err <= 1e-6 * float(np.abs(np.asarray(ja)).max()), f"accum: {err}"
        assert np.array_equal(tt.float().numpy()[PAD], before[0][PAD]), "the pad row moved"

    checks = Checks()
    with torch_threads():
        for dtype in ("f32", "bf16"):
            for n_tables, D in ((1, 128), (2, 64)):
                checks.run(f"sweep_rows_add {dtype} tables={n_tables} D={D}", rows_add, dtype,
                           n_tables, D)
            checks.run(f"sweep AdaGrad step {dtype}", adagrad, dtype)
    checks.done()
