"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The test needs a CUDA card and skips without one (the kernels
have no CPU or interpret mode); the file imports no JAX, so it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Every encoder kernel runs with dropout off and on (p = 0.1, the
flagship's rate; the counter-hash mask is the same on the card and in
the plain version), at flagship-like and ragged shapes: the four
attention kernels at K = 12 and 61 (not multiples of 4 or 8) and at K =
80, 120 and 152 and at a ragged K = 77 (the backwards' key-tiled
kernels; the forwards' query tiles), ``fused_mha_qkv``'s key-tiled
backward also at K = 13 and 64 on request,
``fused_ffn`` at N = 37 and 130
rows (not multiples of its 64-row tile) and F = 40 and 100 (not
multiples of its 64-column hidden chunk); the FM-cross pair runs at the
flagship's QNN shapes and at ragged ones (B, F, D and H*R not multiples
of the kernels' 4-wide tiles); ``sweep_rows_add`` on one and two
tables with duplicates, out-of-range ids, uniform and zipf ids and one
id hot across many of the kernel's 64-position pieces.  Tolerances:

* fp32: 1e-5 of the largest magnitude of each output (the same fp32
  arithmetic in another summation order);
* bf16 activations (the forwards' outputs, dx, do, dz): 3 ulps of the
  largest output (each bf16 rounding point can land one ulp apart when
  the fp32 sums differ in order);
* bf16 weight gradients (fp32 sums over the batch of bf16-rounded
  terms; FM's dU and dV, fp32 sums of bf16 inputs; ``fused_mha``'s
  dbias): 1e-2 of the largest magnitude, since a rounding point that
  lands one ulp apart (2**-8 relative) moves one term of the sum;
* ``sweep_rows_add``: fp32 tables within 1e-5 of the largest magnitude,
  bf16 ones within one ulp of each element (2**-7 relative) plus that:
  the kernel sums a row's duplicates in fp32 in sorted order, piece by
  piece, and the plain version with ``index_add_``'s atomics, so the
  fp32 sums part in their last bits and a row's one rounding can land
  one ulp apart; untouched rows are bit-equal.

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
        fused_ffn,
        fused_ffn_bwd,
        fused_ffn_bwd_reference,
        fused_ffn_reference,
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_qkv,
        fused_mha_qkv_bwd,
        fused_mha_qkv_bwd_reference,
        fused_mha_qkv_reference,
        fused_mha_reference,
        sweep_rows_add,
        sweep_rows_add_reference,
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

    def attention_bwd(dtype, B, K, D, H, p, tiled=False):
        args, do = attn_args(dtype, B, K, D, H)
        x, w, b, bias, _ = args
        before = fused_mha_qkv_bwd.launches
        got = fused_mha_qkv_bwd(x, w, b, bias, do, H, p, SEED, tiled=tiled)
        again = fused_mha_qkv_bwd(x, w, b, bias, do, H, p, SEED, tiled=tiled)
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

    def mha_args(dtype, B, K, D, H):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        gen = torch.Generator().manual_seed(4)
        q, k, v, do = (torch.randn(B, K, D, generator=gen).to(dev, dt) for _ in range(4))
        bias = torch.randn(K, K, generator=gen)
        bias[:, K - 3:] = -1e9  # DARE's masked pad columns
        return (q, k, v, bias.to(dev, dt), H), do

    def mha(dtype, B, K, D, H, p):
        args, do = mha_args(dtype, B, K, D, H)
        before = (fused_mha.launches, fused_mha_bwd.launches)
        got = fused_mha(*args, dropout_p=p, seed=SEED)
        dgot = fused_mha_bwd(*args[:4], do, H, p, SEED)
        again = fused_mha_bwd(*args[:4], do, H, p, SEED)
        torch.cuda.synchronize()
        assert (fused_mha.launches, fused_mha_bwd.launches) == (before[0] + 1, before[1] + 2)
        close("out", dtype, got, fused_mha_reference(*args, dropout_p=p, seed=SEED))
        want = fused_mha_bwd_reference(*args[:4], do, H, p, SEED)
        for i, name in enumerate(("dq", "dk", "dv", "dbias")):
            close(name, dtype, dgot[i], want[i], activation=i < 3)
            assert torch.equal(dgot[i], again[i]), f"{name} changed between two calls"

    def mha_autograd(dtype, B, K, D, H, p):
        """fused_mha's backward is the kernel, dbias in the bias's dtype."""
        args, do = mha_args(dtype, B, K, D, H)
        leaves = [a.detach().requires_grad_() for a in args[:4]]
        before = fused_mha_bwd.launches
        fused_mha(*leaves, H, p, SEED).backward(do)
        torch.cuda.synchronize()
        assert fused_mha_bwd.launches == before + 1
        want = fused_mha_bwd_reference(*args[:4], do, H, p, SEED)
        for i, (name, t) in enumerate(zip(("dq", "dk", "dv", "dbias"), leaves)):
            assert t.grad.dtype == t.dtype, (name, t.grad.dtype)
            close(name, dtype, t.grad, want[i].to(t.dtype), activation=i < 3)

    def ffn_args(dtype, N, D, F):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        gen = torch.Generator().manual_seed(5)
        x, dy = (torch.randn(N, D, generator=gen).to(dev, dt) for _ in range(2))
        w1 = (torch.randn(D, F, generator=gen) * D ** -0.5).to(dev, dt)
        w2 = (torch.randn(F, D, generator=gen) * F ** -0.5).to(dev, dt)
        b1, b2 = (torch.randn(n, generator=gen).mul(0.1).to(dev) for n in (F, D))
        return (x, w1, b1, w2, b2), dy

    def ffn(dtype, N, D, F, p):
        (x, w1, b1, w2, b2), dy = ffn_args(dtype, N, D, F)
        before = (fused_ffn.launches, fused_ffn_bwd.launches)
        got = fused_ffn(x, w1, b1, w2, b2, p, SEED)
        dgot = fused_ffn_bwd(x, w1, b1, w2, dy, p, SEED)
        again = fused_ffn_bwd(x, w1, b1, w2, dy, p, SEED)
        torch.cuda.synchronize()
        assert (fused_ffn.launches, fused_ffn_bwd.launches) == (before[0] + 1, before[1] + 2)
        close("y", dtype, got, fused_ffn_reference(x, w1, b1, w2, b2, p, SEED))
        want = fused_ffn_bwd_reference(x, w1, b1, w2, dy, p, SEED)
        for i, name in enumerate(("dx", "dw1", "db1", "dw2", "db2")):
            close(name, dtype, dgot[i], want[i], activation=i == 0)
            assert torch.equal(dgot[i], again[i]), f"{name} changed between two calls"

    def ffn_autograd(dtype, N, D, F, p):
        """fused_ffn's backward is the kernel, dW in the weights' dtypes."""
        args, dy = ffn_args(dtype, N, D, F)
        leaves = [a.detach().requires_grad_() for a in args]
        before = fused_ffn_bwd.launches
        fused_ffn(*leaves, p, SEED).backward(dy)
        torch.cuda.synchronize()
        assert fused_ffn_bwd.launches == before + 1
        x, w1, b1, w2, _ = args
        want = fused_ffn_bwd_reference(x, w1, b1, w2, dy, p, SEED)
        for i, (name, t) in enumerate(zip(("dx", "dw1", "db1", "dw2", "db2"), leaves)):
            assert t.grad.dtype == t.dtype, (name, t.grad.dtype)
            close(name, dtype, t.grad, want[i].to(t.dtype), activation=i == 0)

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
        q = torch.randn(2, 65, 68, device=dev)
        with pytest.raises(ValueError):
            fused_mha_bwd(q, q, q, torch.zeros(65, 65, device=dev), q, 2)  # D > 64
        x6, w6, b6, bias6 = (torch.from_numpy(a).to(dev) for a in attn_inputs(0, K=80, D=24))
        with pytest.raises(ValueError):  # the key-tiled kernel: dh % 4 == 0
            fused_mha_qkv_bwd(x6, w6, b6, bias6, x6, 4)
        table = torch.zeros(10, 6, device=dev)
        with pytest.raises(ValueError):
            sweep_rows_add([table], torch.zeros(3, dtype=torch.long, device=dev),
                           [torch.zeros(3, 6, device=dev)])  # D % 4
        (x, w1, b1, w2, b2), _ = ffn_args("f32", 8, 68, 40)
        with pytest.raises(ValueError):
            fused_ffn(x, w1, b1, w2, b2)  # D > 64
        z, U, V, g = fm_args("f32", 4, 8, 68, 2, 4, 8)
        with pytest.raises(ValueError):
            fm_cross_pallas(z, U, V)  # D > 64
        z, U, V, g = fm_args("f32", 4, 8, 16, 12, 12, 8)
        with pytest.raises(ValueError):
            fm_cross_pallas_bwd(z, U, V, g)  # H*R > 128

    def sweep(dtype, V, D, n_tables, ids):
        """sweep_rows_add against its plain version on copies of the same
        tables: rows within one ulp, untouched rows unchanged, and a second
        run from the same tables repeats the first bit for bit."""
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        gen = torch.Generator().manual_seed(6)
        tables = [torch.randn(V, D, generator=gen).to(dev, dt) for _ in range(n_tables)]
        deltas = [torch.randn(ids.numel(), D, generator=gen).mul(0.05).to(dev)
                  for _ in range(n_tables)]
        ids = ids.to(dev)
        got, again, want = ([t.clone() for t in tables] for _ in range(3))
        before = sweep_rows_add.launches
        sweep_rows_add(got, ids, deltas)
        sweep_rows_add(again, ids, deltas)
        torch.cuda.synchronize()
        assert sweep_rows_add.launches == before + 2
        sweep_rows_add_reference(want, ids, deltas)
        ulp = 2.0 ** -7 if dtype == "bf16" else 0.0
        touched = torch.zeros(V, dtype=torch.bool, device=dev)
        touched[ids[(ids >= 0) & (ids < V)]] = True
        for t0, g, a, w in zip(tables, got, again, want):
            assert torch.equal(g, a), "sweep_rows_add changed between two calls"
            assert torch.equal(g[~touched], t0[~touched]), "an untouched row changed"
            err = (g.float() - w.float()).abs()
            band = (ulp * torch.maximum(g.float().abs(), w.float().abs())
                    + 1e-5 * float(w.float().abs().max()))
            assert bool((err <= band).all()), f"max err {float(err.max())}"

    def sweep_ids(kind, V, N):
        gen = torch.Generator().manual_seed(7)
        if kind == "uniform":
            return torch.randint(0, V, (N,), generator=gen)
        if kind == "zipf":  # zipf:1.0 over the ids, as bench.py draws them
            w = 1.0 / torch.arange(1, V + 1, dtype=torch.float64)
            return torch.multinomial(w, N, replacement=True, generator=gen)
        ids = torch.randint(0, V, (N,), generator=gen)  # one id hot, a few out of range
        ids[torch.randperm(N, generator=gen)[:N // 2]] = 17
        ids[:5] = torch.tensor([-1, V, V + 7, -30, 2 * V])
        return ids

    checks = Checks()
    for dtype in ("f32", "bf16"):
        for p in (0.0, P_DROP):
            for B, K, D, H in ((6, 80, 64, 8), (4, 120, 64, 8), (3, 152, 64, 8), (5, 77, 64, 8),
                               (4, 77, 16, 4)):
                tag = f"{dtype} p={p} B={B} K={K} D={D} H={H}"
                checks.run(f"attention {tag}", attention, dtype, B, K, D, H, p)
                checks.run(f"attention bwd {tag}", attention_bwd, dtype, B, K, D, H, p)
                checks.run(f"mha {tag}", mha, dtype, B, K, D, H, p)
            for B, K, D, H in ((9, 64, 64, 8), (5, 13, 16, 4)):
                tag = f"{dtype} p={p} B={B} K={K} D={D} H={H}"
                checks.run(f"attention bwd tiled {tag}", attention_bwd, dtype, B, K, D, H, p,
                           True)
        for kind in ("uniform", "zipf", "hot"):
            for n_tables, D in ((1, 128), (2, 16)):
                checks.run(f"sweep {dtype} {kind} tables={n_tables} D={D}", sweep, dtype, 5000,
                           D, n_tables, sweep_ids(kind, 5000, 4000))
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
        for p in (0.0, P_DROP):
            for B, K, D, H in ((64, 64, 64, 8), (9, 61, 64, 8), (5, 12, 16, 4)):
                checks.run(f"mha {dtype} p={p} B={B} K={K} D={D} H={H}", mha, dtype, B, K, D, H, p)
            for N, D, F in ((1000, 64, 384), (37, 16, 40), (130, 64, 100)):
                checks.run(f"ffn {dtype} p={p} N={N} D={D} F={F}", ffn, dtype, N, D, F, p)
        checks.run(f"mha autograd {dtype}", mha_autograd, dtype, 7, 12, 64, 8, P_DROP)
        checks.run(f"ffn autograd {dtype}", ffn_autograd, dtype, 130, 64, 384, P_DROP)
        # (B, F, D, H, R, P): the flagship's QNN at a ragged batch, a ragged
        # shape of every dimension, a single row
        for shape in ((67, 200, 64, 6, 16, 192), (5, 13, 10, 3, 5, 7), (1, 8, 16, 2, 4, 8)):
            checks.run(f"fm cross {dtype} {shape}", fm_cross, dtype, *shape)
        checks.run(f"fm cross autograd {dtype}", fm_cross_autograd, dtype, 9, 16, 16, 2, 4, 8)
    checks.run("kernels refuse what they do not take", kernels_refuse_what_they_do_not_take)
    checks.done()
