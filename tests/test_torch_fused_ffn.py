"""The port's ``fused_ffn`` (the encoder layer's FFN kernel in its
separate-kernel branch) against the JAX package's.

``fused_ffn_reference`` / ``fused_ffn_bwd_reference`` (the plain PyTorch
versions the CUDA kernels are checked against on the card) are held
against ``tossctr_tpu`` ``fused_ffn`` and ``jax.vjp`` of it, run in
interpret mode with ``dropout_impl="hash"``, on the same numpy inputs: N =
37 rows (ragged against the Pallas row blocks of 16 forward and 8
backward, so the mask's absolute row offsets and the padded rows are
exercised), D = 16, F = 32 and 40, dropout off and at p = 0.3:

* fp32 to 1e-5 of each output's largest magnitude: the same arithmetic up
  to summation order;
* bf16 (x, W1, W2 in bf16, the biases fp32, as on the model path): y and
  dx within 3 bf16 ulps of the largest; dW1, dW2 (fp32 sums of
  bf16-rounded terms, returned in the weights' bf16) and db1, db2 within
  1e-2 of the largest magnitude, since a rounding point that lands one
  ulp apart moves one term of the sum.

The hidden-unit mask (``ops/dropout.ffn_keep``) equals both packages'
numpy oracle and does not depend on the block the rows are drawn in.  The
autograd wrapper runs the plain forward and backward on the CPU and
returns each gradient in the dtype JAX's custom_vjp returns it (dW in the
weights' dtype, db in the biases').  One test item (see
``_torch_helpers``).
"""

import numpy as np
import pytest

from _torch_helpers import Checks, bf16_band, torch_threads

P_DROP = 0.3
SEED = 24681357
WGRAD_BAND_BF16 = 1e-2
N = 37


def ffn_inputs(seed, N, D, F):
    rng = np.random.default_rng(seed)

    def r(*s, sd=1.0):
        return rng.normal(0, sd, s).astype(np.float32)

    return [r(N, D), r(D, F, sd=D ** -0.5), r(F, sd=0.1), r(F, D, sd=F ** -0.5), r(D, sd=0.1)]


def _close(name, dtype, got, want, activation=True):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    if dtype == "f32":
        tol = 1e-5 * max(top, 1.0)
    elif activation:
        tol = bf16_band(want)
    else:
        tol = WGRAD_BAND_BF16 * top
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs err {err} > {tol} (largest |want| {top})"


def test_fused_ffn_matches_pallas():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.ops.pallas_ffn import ffn_keep_reference as jax_ffn_keep_reference
    from tossctr_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
    from tossctr_tpu_torch.ops import (
        ffn_keep_reference,
        fused_ffn,
        fused_ffn_bwd_reference,
        fused_ffn_reference,
    )
    from tossctr_tpu_torch.ops.dropout import ffn_keep

    seed_j = jnp.full((1,), SEED, jnp.int32)
    low = (True, True, False, True, False)  # x, w1, b1, w2, b2: which take the compute dtype

    def np32(t):
        return (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t).astype(np.float32))

    def ffn(dtype, p, D, F):
        bf = dtype == "bf16"
        args = ffn_inputs(7, N, D, F)
        dy = np.random.default_rng(8).normal(0, 1, (N, D)).astype(np.float32)
        jargs = [jnp.asarray(a, jnp.bfloat16) if (bf and lo) else jnp.asarray(a)
                 for a, lo in zip(args, low)]
        targs = [torch.from_numpy(a).to(torch.bfloat16) if (bf and lo) else torch.from_numpy(a)
                 for a, lo in zip(args, low)]
        jdy = jnp.asarray(dy, jnp.bfloat16) if bf else jnp.asarray(dy)
        tdy = torch.from_numpy(dy).to(targs[0].dtype)

        jout, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, seed_j, p, 16, True, "hash"), *jargs)
        jgrads = vjp(jdy)
        out = fused_ffn_reference(*targs, p, SEED)
        assert out.dtype == targs[0].dtype
        _close("y", dtype, np32(out), np32(jout))
        x, w1, b1, w2, _ = targs
        tgrads = fused_ffn_bwd_reference(x, w1, b1, w2, tdy, p, SEED)
        for i, name in enumerate(("dx", "dw1", "db1", "dw2", "db2")):
            _close(name, dtype, np32(tgrads[i]), np32(jgrads[i]), activation=i == 0)

        # the autograd wrapper: the same plain forward and backward, each
        # gradient in the dtype JAX's custom_vjp gives it
        leaves = [t.clone().requires_grad_() for t in targs]
        out = fused_ffn(*leaves, p, SEED)
        assert torch.equal(out, fused_ffn_reference(*targs, p, SEED))
        out.backward(tdy)
        for i, leaf in enumerate(leaves):
            want_dtype = torch.bfloat16 if jgrads[i].dtype == jnp.bfloat16 else torch.float32
            assert leaf.grad.dtype == leaf.dtype == want_dtype, (i, leaf.grad.dtype, want_dtype)
            assert torch.equal(leaf.grad, tgrads[i].to(leaf.dtype))

    def masks():
        F = 40
        keep = ffn_keep(N, F, P_DROP, SEED).numpy()
        np.testing.assert_array_equal(keep, ffn_keep_reference(N, F, P_DROP, SEED))
        np.testing.assert_array_equal(keep, jax_ffn_keep_reference(N, F, P_DROP, SEED))
        # a pure function of the absolute row: any block draws the same mask
        np.testing.assert_array_equal(ffn_keep(N - 5, F, P_DROP, SEED, row0=5).numpy(), keep[5:])
        assert 0.6 < float((keep > 0).mean()) < 0.8

    def wrapper_checks_its_inputs():
        t = [torch.from_numpy(a) for a in ffn_inputs(0, 8, 16, 32)]
        with pytest.raises(ValueError):
            fused_ffn(*t, dropout_p=1.0)
        with pytest.raises(ValueError):
            fused_ffn(t[0], t[1], t[2].to(torch.bfloat16), t[3], t[4])  # b1 must stay fp32
        with pytest.raises(ValueError):
            fused_ffn(t[0], t[1][:, :-1], t[2], t[3], t[4])
        before = (fused_ffn.launches, fused_ffn_bwd_launches())
        fused_ffn(*(a.requires_grad_() for a in t)).sum().backward()
        assert (fused_ffn.launches, fused_ffn_bwd_launches()) == before  # CPU: plain versions

    def fused_ffn_bwd_launches():
        from tossctr_tpu_torch.ops import fused_ffn_bwd

        return fused_ffn_bwd.launches

    checks = Checks()
    with torch_threads():
        for dtype in ("f32", "bf16"):
            for p in (0.0, P_DROP):
                for D, F in ((16, 32), (16, 40)):
                    checks.run(f"ffn {dtype} p={p} N={N} D={D} F={F}", ffn, dtype, p, D, F)
        checks.run("hidden-unit masks", masks)
        checks.run("wrapper checks its inputs", wrapper_checks_its_inputs)
    checks.done()
