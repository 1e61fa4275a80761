"""The scatter probe's table sweeps (``tossctr_tpu_torch.ops.table_sweep``)
against the two Pallas kernels of the JAX package's probe
``exp/scatter_probe.py`` in interpret mode: ``_sweep_kernel`` over every
(16, W) block (``probe_dense_sweep``) and ``_sparse_kernel`` over the
scalar-prefetched superblock list (``probe_sparse``), on a (4096, 64)
bf16 table ~ N(0, 0.01^2) as the probe draws it, W in {1024, 4096}, the
list padded with repeats of its last superblock.  Bit-equal: both add the
bf16 marker in fp32 and round once, and a padding repeat adds nothing;
the port's superblock list is the probe's, entry for entry.  Beside them,
the plain versions on a ragged table (the last block partial), which the
probe's grid cannot express: every element swept by the dense sweep, and
only the listed partial block by the sparse one.  One test item (see
``_torch_helpers``).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from _torch_helpers import Checks, torch_threads

ROOT = pathlib.Path(__file__).resolve().parents[1]
V, D = 4096, 64


def _jax_probe():
    """``exp/scatter_probe.py`` as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location("jax_scatter_probe",
                                                  ROOT / "exp" / "scatter_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_list(ids: np.ndarray, W: int) -> np.ndarray:
    """The superblock list as ``probe_sparse`` builds it
    (exp/scatter_probe.py:91-98)."""
    rows_per_sb = 16 * W // D
    n_sb_total = V // rows_per_sb
    sb = np.unique(ids // rows_per_sb)
    cap = min(n_sb_total, len(ids))
    sb_pad = np.full(cap, sb[-1], np.int32)
    sb_pad[:len(sb)] = sb
    return sb_pad


def test_table_sweeps_match_the_pallas_probe():
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import torch
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from tossctr_tpu_torch.ops import table_sweep as ts

    probe = _jax_probe()
    rng = np.random.default_rng(0)
    table = (rng.normal(0, 1, (V, D)) * 0.01).astype(ml_dtypes.bfloat16)

    def torch_table():
        return torch.from_numpy(table.astype(np.float32)).to(torch.bfloat16)

    def as_np(t):
        return t.float().numpy()

    def spec(W, index_map):
        return pl.BlockSpec((16, W), index_map)

    def dense(W):
        rows = V * D // W
        fn = pl.pallas_call(
            probe._sweep_kernel, grid=(rows // 16,), in_specs=[spec(W, lambda i: (i, 0))],
            out_specs=spec(W, lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((rows, W), jnp.bfloat16),
            input_output_aliases={0: 0}, interpret=True)
        want = np.asarray(fn(jnp.asarray(table).reshape(rows, W)).astype(jnp.float32))
        got = ts.dense_sweep(torch_table(), W)
        np.testing.assert_array_equal(as_np(got), want.reshape(V, D))
        assert (as_np(got) != table.astype(np.float32)).any()

    def sparse(W, ids):
        rows = V * D // W
        sb_pad = probe_list(ids, W)
        listed = ts.touched_superblocks(torch.from_numpy(ids), V, D, W)
        assert listed.dtype == torch.int32
        np.testing.assert_array_equal(listed.numpy(), sb_pad)
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(len(sb_pad),),
            in_specs=[spec(W, lambda i, sbr: (sbr[i], 0))],
            out_specs=spec(W, lambda i, sbr: (sbr[i], 0)))
        fn = pl.pallas_call(
            probe._sparse_kernel, grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((rows, W), jnp.bfloat16),
            input_output_aliases={1: 0}, interpret=True)
        want = np.asarray(fn(jnp.asarray(sb_pad), jnp.asarray(table).reshape(rows, W))
                          .astype(jnp.float32)).reshape(V, D)
        got = as_np(ts.sparse_sweep(torch_table(), W, listed))
        np.testing.assert_array_equal(got, want)
        # the untouched superblocks are as they were
        rows_per_sb = 16 * W // D
        untouched = np.setdiff1d(np.arange(V // rows_per_sb), sb_pad)
        blocks = got.reshape(-1, rows_per_sb, D)
        np.testing.assert_array_equal(blocks[untouched],
                                      table.astype(np.float32).reshape(-1, rows_per_sb,
                                                                       D)[untouched])

    def ragged_plain_versions():
        Vr = V + 7  # (V + 7) * 64 elements: 16 whole blocks of 16 * 1024 and a partial one
        t0 = torch.randn(Vr, D, generator=torch.Generator().manual_seed(3)).mul(0.01)
        t0 = t0.to(torch.bfloat16)
        c = ts.marker()
        want = (t0.float() + c).to(torch.bfloat16)
        assert ts.n_blocks(t0, 1024) == 17
        assert torch.equal(ts.dense_sweep(t0.clone(), 1024), want)
        got = ts.sparse_sweep(t0.clone(), 1024, torch.tensor([3, 16, 16], dtype=torch.int32))
        changed = (got != t0).view(-1)
        flat_want = t0.clone().view(-1)
        for lo, hi in ((3 * 16384, 4 * 16384), (16 * 16384, t0.numel())):
            flat_want[lo:hi] = want.view(-1)[lo:hi]
        assert torch.equal(got.view(-1), flat_want)
        assert not changed[:3 * 16384].any() and not changed[4 * 16384:16 * 16384].any()
        empty = ts.touched_superblocks(torch.zeros(0, dtype=torch.long), Vr, D, 1024)
        assert empty.numel() == 0
        assert torch.equal(ts.sparse_sweep(t0.clone(), 1024, empty), t0)
        with pytest.raises(ValueError, match="ascending"):
            ts.sparse_sweep(t0.clone(), 1024, torch.tensor([16, 3, 16], dtype=torch.int32))
        listed = torch.tensor([3, 16], dtype=torch.int32)
        ts.sparse_sweep(t0.clone(), 1024, listed)
        listed[0] = 17  # a list checked once is checked again after a change
        with pytest.raises(ValueError, match="ascending"):
            ts.sparse_sweep(t0.clone(), 1024, listed)

    def cpu_calls_launch_nothing():
        before = (ts.dense_sweep.launches, ts.sparse_sweep.launches)
        ts.dense_sweep(torch_table(), 1024)
        ts.sparse_sweep(torch_table(), 1024, torch.tensor([0, 1], dtype=torch.int32))
        assert (ts.dense_sweep.launches, ts.sparse_sweep.launches) == before

    few = np.sort(rng.integers(1, V // 2, 50)).astype(np.int32)  # half the table: repeats
    many = np.sort(rng.integers(1, V, 3000)).astype(np.int32)  # every superblock touched
    checks = Checks()
    with torch_threads():
        for W in (1024, 4096):
            checks.run(f"dense W={W}", dense, W)
            checks.run(f"sparse W={W} few ids", sparse, W, few)
            checks.run(f"sparse W={W} many ids", sparse, W, many)
        checks.run("ragged plain versions", ragged_plain_versions)
        checks.run("cpu calls launch nothing", cpu_calls_launch_nothing)
    checks.done()
