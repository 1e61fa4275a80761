"""The port's kernel modules against the JAX package's Pallas kernels.

``fused_mha_qkv_reference`` and ``fused_block_tail_reference`` (the plain
PyTorch versions that the CUDA kernels are checked against on the card)
are held against ``tossctr_tpu`` ``fused_mha_qkv`` / ``fused_block_tail``
run in interpret mode, on the same numpy inputs:

* fp32 to 1e-5: the same arithmetic up to summation order;
* bf16 within 3 bf16 ulps of the output's largest magnitude: XLA and
  torch sum in other orders, so an fp32 sum can land on the other side of
  a bf16 rounding point; each rounding point (q/k/v, P, a, r1, y1, g, ff,
  r2, y) can move its value by one ulp.

The wrappers take the plain version only for CPU tensors; the kernels
themselves are checked on the card by ``test_torch_cuda_kernels.py``.
One test item (see ``_torch_helpers``).
"""

import numpy as np
import pytest

from _torch_helpers import LOWP_TAIL, Checks, attn_inputs, bf16_band, run_once, tail_inputs
from _torch_helpers import torch_threads


def test_kernel_modules_match_pallas():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.ops.pallas_attention import fused_mha_qkv as jax_fused_mha_qkv
    from tossctr_tpu.ops.pallas_ffn import fused_block_tail as jax_fused_block_tail
    from tossctr_tpu_torch.ops import (
        fused_block_tail,
        fused_block_tail_reference,
        fused_mha_qkv,
        fused_mha_qkv_reference,
    )

    def jax_attn(x, w, b, bias, H, dtype):
        cast = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dtype == "bf16" else jnp.asarray
        # jitted: run eagerly, an interpret-mode kernel compiles each primitive apart
        out = run_once(lambda *a: jax_fused_mha_qkv(*a, H, 0.0, 64, True),
                       cast(x), cast(w), jnp.asarray(b), cast(bias), jnp.zeros((1,), jnp.int32))
        return np.asarray(out).astype(np.float32)

    def torch_attn(x, w, b, bias, H, dtype, fn=fused_mha_qkv_reference):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        t = lambda a: torch.from_numpy(a).to(dt)  # noqa: E731
        return fn(t(x), t(w), torch.from_numpy(b), t(bias), H).float().numpy()

    def jax_tail(args, dtype):
        out = run_once(
            lambda *a: jax_fused_block_tail(*a, 0.0, 16, True),
            *[jnp.asarray(a, jnp.bfloat16) if (dtype == "bf16" and i in LOWP_TAIL)
              else jnp.asarray(a) for i, a in enumerate(args)],
            jnp.zeros((1,), jnp.int32),
        )
        return np.asarray(out).astype(np.float32)

    def torch_tail(args, dtype, fn=fused_block_tail_reference):
        ts = [torch.from_numpy(a).to(torch.bfloat16 if (dtype == "bf16" and i in LOWP_TAIL)
                                     else torch.float32) for i, a in enumerate(args)]
        return fn(*ts).float().numpy()

    def attention_fp32(seed, H, K, masked):
        x, w, b, bias = attn_inputs(seed, K=K, masked_cols=masked)
        np.testing.assert_allclose(torch_attn(x, w, b, bias, H, "f32"),
                                   jax_attn(x, w, b, bias, H, "f32"), atol=1e-5, rtol=0)

    def attention_bf16(seed):
        x, w, b, bias = attn_inputs(seed, K=16, D=32, masked_cols=4)
        want = jax_attn(x, w, b, bias, 4, "bf16")
        assert np.abs(torch_attn(x, w, b, bias, 4, "bf16") - want).max() <= bf16_band(want)

    def tail_fp32(seed, N, F):
        args = tail_inputs(seed, N=N, F=F)
        np.testing.assert_allclose(torch_tail(args, "f32"), jax_tail(args, "f32"),
                                   atol=1e-5, rtol=0)

    def tail_bf16(seed):
        args = tail_inputs(seed, N=48, D=32, F=64)
        want = jax_tail(args, "bf16")
        assert np.abs(torch_tail(args, "bf16") - want).max() <= bf16_band(want)

    def wrappers_take_the_plain_version_on_cpu():
        counts = (fused_mha_qkv.launches, fused_block_tail.launches)
        x, w, b, bias = attn_inputs(0)
        np.testing.assert_array_equal(torch_attn(x, w, b, bias, 2, "f32", fn=fused_mha_qkv),
                                      torch_attn(x, w, b, bias, 2, "f32"))
        args = tail_inputs(0)
        np.testing.assert_array_equal(torch_tail(args, "bf16", fn=fused_block_tail),
                                      torch_tail(args, "bf16"))
        assert (fused_mha_qkv.launches, fused_block_tail.launches) == counts

    def wrappers_check_their_inputs():
        x, w, b, bias = (torch.from_numpy(a) for a in attn_inputs(0))
        with pytest.raises(ValueError):
            fused_mha_qkv(x, w, b, bias, 2, dropout_p=1.0)
        with pytest.raises(ValueError):
            fused_mha_qkv(x, w, b.double(), bias, 2)
        with pytest.raises(ValueError):
            fused_mha_qkv(x, w[:, :-1], b, bias, 2)
        with pytest.raises(ValueError):
            fused_mha_qkv(x, w, b, bias, 3)
        with pytest.raises(TypeError):
            fused_mha_qkv(x.half(), w.half(), b, bias.half(), 2)
        args = [torch.from_numpy(a) for a in tail_inputs(0)]
        with pytest.raises(ValueError):
            fused_block_tail(*args, dropout_p=-0.1)
        bad = list(args)
        bad[3] = bad[3].to(torch.bfloat16)  # bout must stay fp32
        with pytest.raises(ValueError):
            fused_block_tail(*bad)

    checks = Checks()
    with torch_threads():
        for seed in (0, 1):
            for H, K, masked in ((2, 12, 3), (4, 8, 0), (2, 13, 5)):
                checks.run(f"attention fp32 seed={seed} H={H} K={K} masked={masked}",
                           attention_fp32, seed, H, K, masked)
            for N, F in ((40, 48), (17, 32)):
                checks.run(f"block tail fp32 seed={seed} N={N} F={F}", tail_fp32, seed, N, F)
        for seed in (0, 1, 2):
            checks.run(f"attention bf16 seed={seed}", attention_bf16, seed)
            checks.run(f"block tail bf16 seed={seed}", tail_bf16, seed)
        checks.run("wrappers take the plain version on cpu",
                   wrappers_take_the_plain_version_on_cpu)
        checks.run("wrappers check their inputs", wrappers_check_their_inputs)
    checks.done()
