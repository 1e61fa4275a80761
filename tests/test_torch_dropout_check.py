"""The dropout-mask device check (``tossctr_tpu_torch.exp.
hw_dropout_device_check``) against the JAX package's kernels at the JAX
check's geometry (``exp/hw_dropout_device_check.py``: B = 64, K = 12,
D = 16, H = 8, p = 0.3; the FFN at N = 128, F = 256; its inputs drawn as
it draws them):

* the mask dumps' plain versions (what ``dump_attention_keep`` /
  ``dump_ffn_keep`` return on the CPU) bit for bit against the JAX
  package's numpy oracles ``dropout_keep_reference`` and
  ``ffn_keep_reference``;
* the check's masked float64 oracles of ``fused_mha`` and ``fused_ffn``,
  fed the dumped masks, and the port's plain versions of both (their CPU
  paths, through autograd), forward and the gradients of every input,
  against ``pallas_attention.fused_mha(..., "packed", "hw")`` and
  ``pallas_ffn.fused_ffn(..., "hw")`` in interpret mode, where ``hw``
  resolves to the counter hash (``pallas_attention.py:180-188``): within
  the JAX check's tolerances, 2e-3 forward and 5e-3 gradients;
* and the oracle fed the next seed's mask misses the JAX kernels by far
  more than those tolerances, so the comparison can fail.

The check's card-only parts (the dump kernel, the CUDA kernels, the
persistent grids) run in ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``.  One test item (see ``_torch_helpers``).
"""

import numpy as np

from _torch_helpers import Checks, jitted_vjp, torch_threads

B, K, D, H, P, SEED = 64, 12, 16, 8, 0.3, 1234
N, F = 128, 256
FWD_TOL, GRAD_TOL = 2e-3, 5e-3


def test_dropout_check_matches_the_jax_kernels():
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.ops import pallas_attention as pa
    from tossctr_tpu.ops import pallas_ffn as pf
    from tossctr_tpu_torch.exp import hw_dropout_device_check as chk
    from tossctr_tpu_torch.ops import dump_attention_keep, dump_ffn_keep, fused_ffn, fused_mha

    # the JAX check's inputs, in its order (exp/hw_dropout_device_check.py:40-48, 116-121)
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (B, K, D)).astype(np.float32) for _ in range(3))
    bias = rng.normal(0, 0.1, (K, K)).astype(np.float32)
    g = rng.normal(0, 1, (B, K, D)).astype(np.float32)
    x = rng.normal(0, 1, (N, D)).astype(np.float32)
    w1 = rng.normal(0, 0.1, (D, F)).astype(np.float32)
    b1 = np.zeros(F, np.float32)
    w2 = rng.normal(0, 0.1, (F, D)).astype(np.float32)
    b2 = np.zeros(D, np.float32)
    gy = rng.normal(0, 1, (N, D)).astype(np.float32)
    seed = jnp.asarray([SEED], jnp.int32)
    cpu = torch.device("cpu")

    def t(a):
        return torch.from_numpy(a)

    def close(name, got, want, tol):
        err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
        assert err < tol, f"{name}: {err} >= {tol}"

    attn = jitted_vjp(lambda *a: pa.fused_mha(*a, bias, seed, H, P, 64, False, "packed", "hw"),
                      tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    ffn = jitted_vjp(lambda *a: pf.fused_ffn(*a, seed, P, 512, False, "hw"),
                     tuple(map(jnp.asarray, (x, w1, b1, w2, b2))), jnp.asarray(gy))

    def masks():
        keep = dump_attention_keep(B, K, H, P, SEED, cpu).numpy()
        np.testing.assert_array_equal(keep, pa.dropout_keep_reference(B, K, K, H, P, SEED)
                                      .transpose(1, 0, 2, 3))
        np.testing.assert_array_equal(dump_ffn_keep(N, F, P, SEED, cpu).numpy(),
                                      pf.ffn_keep_reference(N, F, P, SEED))

    def mha_oracle(seed_offset=0, tol=(FWD_TOL, GRAD_TOL)):
        keep = dump_attention_keep(B, K, H, P, SEED + seed_offset, cpu)
        out, (dq, dk, dv), _ = chk.oracle_vjp(chk.mha_oracle, [t(q), t(k), t(v)], [t(bias)],
                                              keep, t(g), B, H)
        (want, grads) = attn
        close("fused_mha oracle forward", out, want, tol[0])
        for name, a, b in zip("qkv", (dq, dk, dv), grads):
            close(f"fused_mha oracle d{name}", a, b, tol[1])

    def mha_plain():
        ins = [t(a).requires_grad_() for a in (q, k, v)]
        out = fused_mha(*ins, t(bias), H, P, SEED)
        grads = torch.autograd.grad(out, ins, t(g))
        close("fused_mha plain forward", out.detach(), attn[0], FWD_TOL)
        for name, a, b in zip("qkv", grads, attn[1]):
            close(f"fused_mha plain d{name}", a, b, GRAD_TOL)

    def ffn_oracle(seed_offset=0):
        keep = dump_ffn_keep(N, F, P, SEED + seed_offset, cpu)
        out, (dx,), dws = chk.oracle_vjp(chk.ffn_oracle, [t(x)], [t(a) for a in (w1, b1, w2, b2)],
                                         keep, t(gy), N)
        close("fused_ffn oracle forward", out, ffn[0], FWD_TOL)
        for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), [dx] + dws, ffn[1]):
            close(f"fused_ffn oracle d{name}", a, b, GRAD_TOL)

    def ffn_plain():
        ins = [t(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
        out = fused_ffn(*ins, P, SEED)
        grads = torch.autograd.grad(out, ins, t(gy))
        close("fused_ffn plain forward", out.detach(), ffn[0], FWD_TOL)
        for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), grads, ffn[1]):
            close(f"fused_ffn plain d{name}", a, b, GRAD_TOL)

    def another_mask_misses():
        for fn in (lambda: mha_oracle(1, (0.1, 0.1)), lambda: ffn_oracle(1)):
            try:
                fn()
            except AssertionError:
                continue
            raise AssertionError("the oracle on the next seed's mask matched the kernel")

    checks = Checks()
    with torch_threads():
        checks.run("masks", masks)
        checks.run("fused_mha oracle", mha_oracle)
        checks.run("fused_mha plain", mha_plain)
        checks.run("fused_ffn oracle", ffn_oracle)
        checks.run("fused_ffn plain", ffn_plain)
        checks.run("another mask misses", another_mask_misses)
    checks.done()
