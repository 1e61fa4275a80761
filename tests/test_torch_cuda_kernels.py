"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The test needs a CUDA card and skips without one (the kernels
have no CPU or interpret mode); the file imports no JAX, so it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Every encoder kernel runs with dropout off and on (p = 0.1, the
flagship's rate; the counter-hash mask is the same on the card and in
the plain version); the FM-cross pair runs at the flagship's QNN shapes
and at ragged ones (B, F, D and H*R not multiples of the kernels' 4-wide
tiles).  Tolerances:

* fp32: 1e-5 of the largest magnitude of each output (the same fp32
  arithmetic in another summation order);
* bf16 activations (the forwards' outputs, dx, do, dz): 3 ulps of the
  largest output (each bf16 rounding point can land one ulp apart when
  the fp32 sums differ in order);
* bf16 weight gradients (fp32 sums over the batch of bf16-rounded
  terms; FM's dU and dV, fp32 sums of bf16 inputs): 1e-2 of the largest
  magnitude, since a rounding point that lands one ulp apart (2**-8
  relative) moves one term of the sum.

The backward kernels reduce their per-block partial sums in a fixed
order, so a second call must repeat the first bit for bit.  One test
item (see ``_torch_helpers``).
"""

import pytest

from _torch_helpers import LOWP_TAIL, Checks, attn_inputs, bf16_band, tail_inputs

P_DROP = 0.1
SEED = 1234567
WGRAD_BAND_BF16 = 1e-2


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")

    from tossctr_tpu_torch.ops import (
        fm_cross_pallas,
        fm_cross_pallas_bwd,
        fm_cross_pallas_bwd_reference,
        fm_cross_pallas_reference,
        fused_block_tail,
        fused_block_tail_bwd,
        fused_block_tail_bwd_reference,
        fused_block_tail_reference,
        fused_mha_qkv,
        fused_mha_qkv_bwd,
        fused_mha_qkv_bwd_reference,
        fused_mha_qkv_reference,
    )

    from tossctr_tpu_torch.ops.fm_cross import fm_cross_pallas_fwd as fm_cross_pallas_fwd_only

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def close(name, dtype, got, want, activation=True):
        assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, got.shape)
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        if dtype == "f32":
            tol = 1e-5 * max(top, 1.0)
        elif activation:
            tol = bf16_band(want.float().cpu().numpy())
        else:
            tol = WGRAD_BAND_BF16 * top
        assert err <= tol, f"{name}: max abs err {err} > {tol} (largest |want| {top})"

    def attn_args(dtype, B, K, D, H):
        x, w, b, bias = attn_inputs(0, B=B, K=K, D=D, masked_cols=4)
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        t = [torch.from_numpy(a).to(dev) for a in (x, w, b, bias)]
        do = torch.randn(B, K, D, generator=torch.Generator().manual_seed(1)).to(dev, dt)
        return (t[0].to(dt), t[1].to(dt), t[2], t[3].to(dt), H), do

    def tail_args(dtype, N, D, F):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        ts = [torch.from_numpy(a).to(dev).to(dt if i in LOWP_TAIL else torch.float32)
              for i, a in enumerate(tail_inputs(0, N=N, D=D, F=F))]
        dy = torch.randn(N, D, generator=torch.Generator().manual_seed(2)).to(dev, dt)
        return ts, dy

    def attention(dtype, B, K, D, H, p):
        args, _ = attn_args(dtype, B, K, D, H)
        before = fused_mha_qkv.launches
        got = fused_mha_qkv(*args, dropout_p=p, seed=SEED)
        torch.cuda.synchronize()
        assert fused_mha_qkv.launches == before + 1
        close("out", dtype, got, fused_mha_qkv_reference(*args, dropout_p=p, seed=SEED))

    def attention_bwd(dtype, B, K, D, H, p):
        args, do = attn_args(dtype, B, K, D, H)
        x, w, b, bias, _ = args
        before = fused_mha_qkv_bwd.launches
        got = fused_mha_qkv_bwd(x, w, b, bias, do, H, p, SEED)
        again = fused_mha_qkv_bwd(x, w, b, bias, do, H, p, SEED)
        torch.cuda.synchronize()
        assert fused_mha_qkv_bwd.launches == before + 2
        want = fused_mha_qkv_bwd_reference(x, w, b, bias, do, H, p, SEED)
        for i, name in enumerate(("dx", "dwqkv", "dbqkv", "dbias")):
            close(name, dtype, got[i], want[i], activation=i == 0)
            assert torch.equal(got[i], again[i]), f"{name} changed between two calls"

    def attention_autograd(dtype, B, K, D, H, p):
        """fused_mha_qkv's backward is the kernel, with the weights' dtypes."""
        args, do = attn_args(dtype, B, K, D, H)
        x, w, b, bias, _ = (a.detach().requires_grad_() if i < 4 else a
                            for i, a in enumerate(args))
        before = fused_mha_qkv_bwd.launches
        fused_mha_qkv(x, w, b, bias, H, p, SEED).backward(do)
        torch.cuda.synchronize()
        assert fused_mha_qkv_bwd.launches == before + 1
        want = fused_mha_qkv_bwd_reference(x.detach(), w.detach(), b.detach(), bias.detach(),
                                           do, H, p, SEED)
        for name, t, ref in (("dx", x, want[0]), ("dwqkv", w, want[1]), ("dbqkv", b, want[2]),
                             ("dbias", bias, want[3])):
            assert t.grad.dtype == t.dtype, (name, t.grad.dtype)
            close(name, dtype, t.grad, ref.to(t.dtype), activation=name == "dx")

    def block_tail(dtype, N, D, F, p):
        ts, _ = tail_args(dtype, N, D, F)
        before = fused_block_tail.launches
        got = fused_block_tail(*ts, dropout_p=p, seed=SEED)
        torch.cuda.synchronize()
        assert fused_block_tail.launches == before + 1
        close("y", dtype, got, fused_block_tail_reference(*ts, dropout_p=p, seed=SEED))

    def block_tail_bwd(dtype, N, D, F, p):
        ts, dy = tail_args(dtype, N, D, F)
        before = fused_block_tail_bwd.launches
        got = fused_block_tail_bwd(*ts, dy, p, SEED)
        again = fused_block_tail_bwd(*ts, dy, p, SEED)
        torch.cuda.synchronize()
        assert fused_block_tail_bwd.launches == before + 2
        want = fused_block_tail_bwd_reference(*ts, dy, p, SEED)
        names = ("dx", "do", "dwout", "dbout", "dwn1", "dw1", "db1", "dw2", "db2", "dwn2")
        for i, name in enumerate(names):
            close(name, dtype, got[i], want[i], activation=i < 2)
            assert torch.equal(got[i], again[i]), f"{name} changed between two calls"

    def fm_args(dtype, B, F, D, Hh, R, P):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        gen = torch.Generator().manual_seed(3)
        z = torch.randn(B, F, D, generator=gen)
        U = torch.randn(Hh, D, R, generator=gen) * 0.1
        V = torch.randn(Hh, R, P, generator=gen) * 0.1
        g = torch.randn(B, Hh * P, generator=gen)
        return [t.to(dev, dt) for t in (z, U, V, g)]

    def fm_cross(dtype, *shape):
        z, U, V, g = fm_args(dtype, *shape)
        before = (fm_cross_pallas.launches, fm_cross_pallas_bwd.launches)
        got = fm_cross_pallas_fwd_only(z, U, V)
        dgot = fm_cross_pallas_bwd(z, U, V, g)
        again = fm_cross_pallas_bwd(z, U, V, g)
        torch.cuda.synchronize()
        assert (fm_cross_pallas.launches, fm_cross_pallas_bwd.launches) == (before[0] + 1,
                                                                           before[1] + 2)
        close("out", dtype, got, fm_cross_pallas_reference(z, U, V))
        want = fm_cross_pallas_bwd_reference(z, U, V, g)
        for i, name in enumerate(("dz", "dU", "dV")):
            close(name, dtype, dgot[i], want[i], activation=i == 0)
            assert torch.equal(dgot[i], again[i]), f"{name} changed between two calls"

    def fm_cross_autograd(dtype, *shape):
        """fm_cross_pallas's backward is the kernel, dU and dV in U's and V's dtypes."""
        z, U, V, g = fm_args(dtype, *shape)
        leaves = [t.detach().requires_grad_() for t in (z, U, V)]
        before = fm_cross_pallas_bwd.launches
        fm_cross_pallas(*leaves).backward(g)
        torch.cuda.synchronize()
        assert fm_cross_pallas_bwd.launches == before + 1
        want = fm_cross_pallas_bwd_reference(z, U, V, g)
        for name, t, ref in zip(("dz", "dU", "dV"), leaves, want):
            assert t.grad.dtype == t.dtype, (name, t.grad.dtype)
            close(name, dtype, t.grad, ref.to(t.dtype), activation=name == "dz")

    def kernels_refuse_what_they_do_not_take():
        x, w, b, bias = (torch.from_numpy(a).to(dev) for a in attn_inputs(0))
        with pytest.raises(ValueError):
            fused_mha_qkv(x.transpose(1, 2).contiguous().transpose(1, 2), w, b, bias, 2)
        with pytest.raises(ValueError):
            fused_mha_qkv(x, w, b, bias, 2, dropout_p=1.0)
        ts = [torch.from_numpy(a).to(dev) for a in tail_inputs(0, D=68, F=40)]
        with pytest.raises(ValueError):
            fused_block_tail(*ts)  # D > 64
        with pytest.raises(ValueError):
            fused_block_tail_bwd(*ts, ts[0])  # D > 64
        z, U, V, g = fm_args("f32", 4, 8, 68, 2, 4, 8)
        with pytest.raises(ValueError):
            fm_cross_pallas(z, U, V)  # D > 64
        z, U, V, g = fm_args("f32", 4, 8, 16, 12, 12, 8)
        with pytest.raises(ValueError):
            fm_cross_pallas_bwd(z, U, V, g)  # H*R > 128

    checks = Checks()
    for dtype in ("f32", "bf16"):
        for p in (0.0, P_DROP):
            for B, K, D, H in ((64, 64, 64, 8), (9, 61, 64, 8), (5, 13, 16, 4)):
                tag = f"{dtype} p={p} B={B} K={K} D={D} H={H}"
                checks.run(f"attention {tag}", attention, dtype, B, K, D, H, p)
                checks.run(f"attention bwd {tag}", attention_bwd, dtype, B, K, D, H, p)
            for N, D, F in ((1000, 64, 384), (37, 16, 40), (130, 64, 100)):
                tag = f"{dtype} p={p} N={N} D={D} F={F}"
                checks.run(f"block tail {tag}", block_tail, dtype, N, D, F, p)
                checks.run(f"block tail bwd {tag}", block_tail_bwd, dtype, N, D, F, p)
        checks.run(f"attention autograd {dtype}", attention_autograd, dtype, 7, 64, 64, 8, P_DROP)
        # (B, F, D, H, R, P): the flagship's QNN at a ragged batch, a ragged
        # shape of every dimension, a single row
        for shape in ((67, 200, 64, 6, 16, 192), (5, 13, 10, 3, 5, 7), (1, 8, 16, 2, 4, 8)):
            checks.run(f"fm cross {dtype} {shape}", fm_cross, dtype, *shape)
        checks.run(f"fm cross autograd {dtype}", fm_cross_autograd, dtype, 9, 16, 16, 2, 4, 8)
    checks.run("kernels refuse what they do not take", kernels_refuse_what_they_do_not_take)
    checks.done()
