"""The port's kernel modules with dropout, forward and backward, against
the JAX package's Pallas kernels.

``fused_mha_qkv_reference`` / ``fused_mha_qkv_bwd_reference`` and
``fused_block_tail_reference`` / ``fused_block_tail_bwd_reference`` (the
plain PyTorch versions the CUDA kernels are checked against on the card)
are held against ``tossctr_tpu`` ``fused_mha_qkv`` / ``fused_block_tail``
and ``jax.vjp`` of them, run in interpret mode with
``dropout_impl="hash"``, on the same numpy inputs, with dropout off and
on (p = 0.1, a fixed seed), at ragged K (not a multiple of the Pallas
kernel's 8-row tile) and ragged N:

* fp32 to 1e-5 of each output's largest magnitude: the same arithmetic up
  to summation order;
* bf16 activations (outputs, dx, do) within 3 bf16 ulps of the largest
  output, as ``test_torch_kernels.py`` states;
* bf16 weight gradients (which the Pallas custom_vjp returns in the
  weights' bf16) within 1e-2 of the largest magnitude: a bf16 rounding
  point that lands one ulp (2**-8) apart moves one term of their sums.

The wrappers' autograd (``torch.autograd.Function``) is checked against
the plain backward: on a CPU tensor the backward is that plain version.
One test item (see ``_torch_helpers``).
"""

import numpy as np

from _torch_helpers import (
    LOWP_TAIL,
    Checks,
    attn_inputs,
    bf16_band,
    jitted_vjp,
    tail_inputs,
    torch_threads,
)

P_DROP = 0.1
SEED = 987654321
WGRAD_BAND_BF16 = 1e-2


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


def test_kernel_backwards_match_pallas():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.ops.pallas_attention import fused_mha_qkv as jax_fused_mha_qkv
    from tossctr_tpu.ops.pallas_ffn import fused_block_tail as jax_fused_block_tail
    from tossctr_tpu_torch.ops import (
        fused_block_tail,
        fused_block_tail_bwd_reference,
        fused_block_tail_reference,
        fused_mha_qkv,
        fused_mha_qkv_bwd_reference,
        fused_mha_qkv_reference,
    )

    def jcast(a, low, dtype):
        return jnp.asarray(a, jnp.bfloat16) if (dtype == "bf16" and low) else jnp.asarray(a)

    def tcast(a, low, dtype):
        t = torch.from_numpy(np.asarray(a))
        return t.to(torch.bfloat16) if (dtype == "bf16" and low) else t

    def np32(t):
        return (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t).astype(np.float32))

    seed_j = jnp.full((1,), SEED, jnp.int32)

    def attention(dtype, p, B, K, D, H):
        x, w, b, bias = attn_inputs(3, B=B, K=K, D=D, masked_cols=3)
        do = np.random.default_rng(4).normal(0, 1, (B, K, D)).astype(np.float32)
        low = (True, True, False, True)
        jargs = [jcast(a, lo, dtype) for a, lo in zip((x, w, b, bias), low)]
        targs = [tcast(a, lo, dtype) for a, lo in zip((x, w, b, bias), low)]
        jdo, tdo = jcast(do, True, dtype), tcast(do, True, dtype)

        def jfn(x_, w_, b_, bias_):
            return jax_fused_mha_qkv(x_, w_, b_, bias_, seed_j, H, p, 64, True,
                                     "packed", "hash")

        jout, jgrads = jitted_vjp(jfn, jargs, jdo)
        _close("out", dtype, np32(fused_mha_qkv_reference(*targs, H, p, SEED)), np32(jout))
        tgrads = fused_mha_qkv_bwd_reference(*targs, tdo, H, p, SEED)
        for i, name in enumerate(("dx", "dwqkv", "dbqkv", "dbias")):
            _close(name, dtype, np32(tgrads[i]), np32(jgrads[i]), activation=i == 0)

        # the autograd wrapper runs the same plain forward and backward
        leaves = [t.clone().requires_grad_() for t in targs]
        out = fused_mha_qkv(*leaves, H, p, SEED)
        assert torch.equal(out, fused_mha_qkv_reference(*targs, H, p, SEED))
        out.backward(tdo)
        for i, leaf in enumerate(leaves):
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, tgrads[i].to(leaf.dtype))

    def block_tail(dtype, p, N, D, F):
        args = tail_inputs(5, N=N, D=D, F=F)
        dy = np.random.default_rng(6).normal(0, 1, (N, D)).astype(np.float32)
        jargs = [jcast(a, i in LOWP_TAIL, dtype) for i, a in enumerate(args)]
        targs = [tcast(a, i in LOWP_TAIL, dtype) for i, a in enumerate(args)]
        jdy, tdy = jcast(dy, True, dtype), tcast(dy, True, dtype)

        def jfn(*a):
            return jax_fused_block_tail(*a, seed_j, p, 16, True, "hash")

        jout, jgrads = jitted_vjp(jfn, jargs, jdy)
        _close("y", dtype, np32(fused_block_tail_reference(*targs, p, SEED)), np32(jout))
        tgrads = fused_block_tail_bwd_reference(*targs, tdy, p, SEED)
        names = ("dx", "do", "dwout", "dbout", "dwn1", "dw1", "db1", "dw2", "db2", "dwn2")
        for i, name in enumerate(names):
            _close(name, dtype, np32(tgrads[i]), np32(jgrads[i]), activation=i < 2)

        leaves = [t.clone().requires_grad_() for t in targs]
        fused_block_tail(*leaves, p, SEED).backward(tdy)
        for i, leaf in enumerate(leaves):
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, tgrads[i].to(leaf.dtype))

    checks = Checks()
    with torch_threads():
        for dtype in ("f32", "bf16"):
            for p in (0.0, P_DROP):
                # ragged K and N in every case; a second shape on the
                # training path's own setting (bf16, dropout on)
                main = dtype == "bf16" and p > 0
                for B, K, D, H in ((3, 13, 16, 2),) + (((2, 8, 32, 4),) if main else ()):
                    checks.run(f"attention {dtype} p={p} B={B} K={K} D={D} H={H}",
                               attention, dtype, p, B, K, D, H)
                for N, D, F in ((37, 16, 40),) + (((24, 32, 64),) if main else ()):
                    checks.run(f"block tail {dtype} p={p} N={N} D={D} F={F}",
                               block_tail, dtype, p, N, D, F)
    checks.done()
