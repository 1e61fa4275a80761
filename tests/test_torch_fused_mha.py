"""The port's ``fused_mha`` (attention on already-projected q, k, v) and
``MultiHeadSelfAttention`` against the JAX package's.

``fused_mha_reference`` / ``fused_mha_bwd_reference`` (the plain PyTorch
versions the CUDA kernels are checked against on the card) are held
against ``tossctr_tpu`` ``fused_mha`` and ``jax.vjp`` of it, run in
interpret mode with ``dropout_impl="hash"``, on the same numpy inputs: B =
4 in batch blocks of 2 (so the mask's absolute row offsets are
exercised), H = 2, D = 16, K = 8 and 12 (12 is not a multiple of the
Pallas kernels' 8-row tile, which pad it to 16 and mask the padded key
columns), dropout off and at p = 0.3, through the packed kernel (the
default) and the loop kernel:

* fp32 to 1e-5 of each output's largest magnitude, dbias included;
* bf16: the output, dq, dk and dv within 3 bf16 ulps of the largest;
  dbias (an fp32 sum over the batch and the heads of terms computed from
  bf16-rounded values, returned in the bias's bf16) within 1e-2 of its
  largest magnitude.

The attention mask (``ops/dropout.attention_keep``) equals both packages'
``dropout_keep_reference``, and the packed and loop kernels draw the same
one, as ``fused_mha``'s docstring says.  The autograd wrapper runs the
plain forward and backward on the CPU, each gradient in its input's
dtype.  ``MultiHeadSelfAttention`` in its three modes (the fused-qkv
kernel, the qkv Dense + ``fused_mha``, the plain einsum path) is held
against the flax module on converted parameters in fp32 with dropout off:
the output and the gradients of x, the bias and every parameter within
1e-5 of each one's largest magnitude.  One test item (see
``_torch_helpers``).
"""

import numpy as np
import pytest

from _torch_helpers import Checks, bf16_band, jitted_vjp, run_once, torch_threads

P_DROP = 0.3
SEED = 13579
WGRAD_BAND_BF16 = 1e-2
B, H, D = 4, 2, 16


def mha_inputs(seed, K, masked_cols=0):
    """q, k, v (B, K, D), bias (K, K), do (B, K, D); the last
    ``masked_cols`` key columns carry -1e9, as DARE's valid_k mask does."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, (B, K, D)).astype(np.float32) for _ in range(4))
    bias = rng.normal(0, 1, (K, K)).astype(np.float32)
    if masked_cols:
        bias[:, K - masked_cols:] = -1e9
    return q, k, v, bias, do


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


def test_fused_mha_matches_pallas():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.models.layers import MultiHeadSelfAttention as JaxMHA
    from tossctr_tpu.ops.pallas_attention import dropout_keep_reference as jax_keep_reference
    from tossctr_tpu.ops.pallas_attention import fused_mha as jax_fused_mha
    from tossctr_tpu_torch.convert import flax_to_state_dict
    from tossctr_tpu_torch.models.layers import MultiHeadSelfAttention
    from tossctr_tpu_torch.ops import (
        dropout_keep_reference,
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_reference,
    )
    from tossctr_tpu_torch.ops.dropout import attention_keep

    seed_j = jnp.full((1,), SEED, jnp.int32)

    def np32(t):
        return (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t).astype(np.float32))

    def core(dtype, p, K, impl):
        bf = dtype == "bf16"
        q, k, v, bias, do = mha_inputs(3, K, masked_cols=2 if K == 12 else 0)
        jargs = [jnp.asarray(a, jnp.bfloat16 if bf else jnp.float32) for a in (q, k, v, bias)]
        targs = [torch.from_numpy(a).to(torch.bfloat16 if bf else torch.float32)
                 for a in (q, k, v, bias)]
        tdo = torch.from_numpy(do).to(targs[0].dtype)

        def jfn(*a):
            return jax_fused_mha(*a, seed_j, H, p, 2, True, impl, "hash")

        jout, jgrads = jitted_vjp(jfn, jargs, jnp.asarray(do, jargs[0].dtype))
        _close("out", dtype, np32(fused_mha_reference(*targs, H, p, SEED)), np32(jout))
        tgrads = fused_mha_bwd_reference(*targs, tdo, H, p, SEED)
        for i, name in enumerate(("dq", "dk", "dv", "dbias")):
            _close(name, dtype, np32(tgrads[i]), np32(jgrads[i]), activation=i < 3)

        leaves = [t.clone().requires_grad_() for t in targs]
        out = fused_mha(*leaves, H, p, SEED)
        assert torch.equal(out, fused_mha_reference(*targs, H, p, SEED))
        out.backward(tdo)
        for i, leaf in enumerate(leaves):
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, tgrads[i].to(leaf.dtype))

    def masks(K):
        keep = attention_keep(B, K, H, P_DROP, SEED).numpy()  # (B, H, K, K)
        want = jax_keep_reference(B, K, K, H, P_DROP, SEED).transpose(1, 0, 2, 3)
        np.testing.assert_array_equal(keep, want)
        np.testing.assert_array_equal(
            keep, dropout_keep_reference(B, K, K, H, P_DROP, SEED).transpose(1, 0, 2, 3))
        np.testing.assert_array_equal(attention_keep(B - 1, K, H, P_DROP, SEED, row0=1).numpy(),
                                      keep[1:])

    def packed_and_loop_draw_one_mask(K):
        q, k, v, bias, _ = mha_inputs(5, K)
        outs = [np.asarray(jax_fused_mha(*map(jnp.asarray, (q, k, v, bias)), seed_j, H, P_DROP,
                                         2, True, impl, "hash")) for impl in ("packed", "loop")]
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=0)

    def module(use_pallas, fuse_qkv, K=12):
        x, _, _, bias, g = mha_inputs(9, K, masked_cols=2)
        jm = JaxMHA(D, H, 0.0, use_pallas=use_pallas, fuse_qkv=fuse_qkv)
        jbias = jnp.asarray(bias)[None, None]
        variables = run_once(lambda k_, x_, b_: jm.init(k_, x_, attn_bias=b_),
                             jax.random.PRNGKey(0), jnp.asarray(x), jbias)

        def jloss(params, x_, bias_):
            out = jm.apply({"params": params}, x_, attn_bias=bias_[None, None])
            return jnp.sum(out * g), out

        (_, jout), jgrads = run_once(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True),
                                     variables["params"], jnp.asarray(x), jnp.asarray(bias))
        tm = MultiHeadSelfAttention(D, H, 0.0, use_pallas=use_pallas, fuse_qkv=fuse_qkv)
        tm.load_state_dict(flax_to_state_dict(jax.device_get(variables)), strict=True)
        tx = torch.from_numpy(x).requires_grad_()
        tb = torch.from_numpy(bias).requires_grad_()
        counts = (fused_mha.launches, fused_mha_bwd.launches)
        out = tm(tx, tb)
        (out * torch.from_numpy(g)).sum().backward()
        assert (fused_mha.launches, fused_mha_bwd.launches) == counts  # CPU: plain versions
        _close("out", "f32", out.detach().numpy(), np.asarray(jout))
        _close("dx", "f32", tx.grad.numpy(), np.asarray(jgrads[1]))
        _close("dbias", "f32", tb.grad.numpy(), np.asarray(jgrads[2]))
        jp = flax_to_state_dict(jax.device_get(jgrads[0]))
        for name, prm in tm.named_parameters():
            _close(f"d{name}", "f32", prm.grad.numpy(), jp[name].numpy())

    def wrapper_checks_its_inputs():
        q, k, v, bias, _ = (torch.from_numpy(a) for a in mha_inputs(0, 8))
        with pytest.raises(ValueError):
            fused_mha(q, k, v, bias, 3)  # D % H
        with pytest.raises(ValueError):
            fused_mha(q, k[:, :-1], v, bias, H)
        with pytest.raises(ValueError):
            fused_mha(q, k, v, bias.to(torch.bfloat16), H)
        with pytest.raises(ValueError):
            fused_mha(q, k, v, bias, H, dropout_p=1.0)

    checks = Checks()
    with torch_threads():
        for dtype in ("f32", "bf16"):
            for p in (0.0, P_DROP):
                for K in (8, 12):
                    checks.run(f"fused_mha {dtype} p={p} K={K}", core, dtype, p, K, "packed")
        checks.run("fused_mha f32 p=0.3 K=12 loop kernel", core, "f32", P_DROP, 12, "loop")
        for K in (8, 12):
            checks.run(f"attention masks K={K}", masks, K)
        checks.run("packed and loop kernels draw one mask", packed_and_loop_draw_one_mask, 12)
        for use_pallas, fuse_qkv in ((True, True), (True, False), (False, True)):
            checks.run(f"MultiHeadSelfAttention use_pallas={use_pallas} fuse_qkv={fuse_qkv}",
                       module, use_pallas, fuse_qkv)
        checks.run("wrapper checks its inputs", wrapper_checks_its_inputs)
    checks.done()
