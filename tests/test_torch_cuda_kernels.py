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
kernels; the forwards' query tiles), ``fused_mha_qkv``'s fp32
key-tiled backward also at K = 13 and 64 on request, the two bf16
forwards' warp-unit kernels (K <= 160; ``fused_mha``'s on the tensor
cores, ``fused_mha_qkv``'s bit-equal to its tiled kernel) at K = 12, 13,
60, 64, 77, 80, 120, 128, 129, 152 and 160, at every head width they
take (4, 8, 12, 16; D = 32, 48 and 64), at grids of 1 and 7 blocks,
beside the tiled CUDA-core kernels at the bf16 shapes they keep (a head
width of 32, heads padded past 64 columns, K = 161) and the refusal of
unaligned tensors, the two bf16 backwards' tensor-core kernels (K <=
160) at every head width they take (4, 8, 12, 16; D = 32, 48 and 64), at
K = 12, 17, 33, 60, 64, 65, 97, 100, 121 and 128 (dbias in registers)
and at K = 129, 137, 152 and 160 (10 warps, dbias in device memory), at
grids of 1 and 7 blocks, through autograd (at K = 152 too), beside the
key-tiled CUDA-core backwards at the bf16 shapes they keep (K = 161; at
K = 152 16 heads of 4, padded past 64 columns),
and their refusals of the head widths they do not take at K <= 128,
``fused_ffn`` at N = 37 and 130
rows (not multiples of its row tiles) and F = 40 and 100 (not
multiples of its 64-column hidden chunk), at D = 32, F = 64, at N =
132 * 64 * 3 + 37 (several persistent walks with a ragged end) and at F
= 1024 (the bf16 forward's weights in two panels), its backward also at
grids of 1 and 7 blocks; the ``fused_block_tail`` pair (bf16 on the
tensor cores) at D = 16, 24, 48 and 64, F = 64, 200, 384 and 1024 (the
weights in panels), rows that fill no whole tile, several persistent
walks, its backward at grids of 1 and 7 blocks (dx and do bit-equal to
the default grid's) and through autograd; the FM-cross pair runs at the
flagship's QNN shapes and at ragged ones (B, F, D and H*R not multiples
of the CUDA-core kernels' 4-wide tiles), and its bf16 tensor-core pair
at the edges of its tiling: B not a multiple of its 8-row groups (67,
8192 + 37), F not a multiple of its 16-row m-tiles (5, 8, 17, 24, 200),
R = 8 (a k8 step; H*R = 128) and 32, D = 16, 24 (padded to 32) and 48,
H*R padded to a multiple of 16, P not a multiple of 8, and at grids of
1 and 3 blocks (out and dz bit-equal to the default grid's); ``sweep_rows_add`` on one and two
tables (each with its own delta tensor) with duplicates, out-of-range
ids, uniform and zipf ids and one id hot across many of the kernel's
64-position pieces, N not a multiple of a piece, fp32 deltas and (on
bf16 tables) bf16 ones, N = 0 and 1, and its refusal of deltas of
another dtype, of mixed dtypes, not contiguous or not aligned; the
scatter probe's two table sweeps on bf16 tables whose size is and is
not a multiple of a (16, W) block, of the kernel's 8192-element item and
of 8 elements, one of thousands of items, the sparse one over lists
with padding repeats, ids outside the table and none at all; the
dropout-mask dump
kernel at the attention and FFN geometries and ragged shapes; and the
persistent kernels at a grid of a few blocks against their default
grid.  Tolerances:

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
  one ulp apart; untouched rows are bit-equal;
* the table sweeps and the mask dumps: bit-equal to their plain versions
  (one fp32 add and one rounding an element; the same integer hash);
* a persistent kernel at another grid: outputs and activation gradients
  bit-equal (a row's arithmetic does not depend on the block that takes
  it), fp32 weight-gradient sums within 1e-5 of the largest magnitude
  (their per-block partials regroup).

The backward kernels reduce their per-block partial sums in a fixed
order, so a second call must repeat the first bit for bit.  One test
item (see ``_torch_helpers``).
"""

import importlib

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
    from tossctr_tpu_torch.ops import dropout as dropout_masks
    from tossctr_tpu_torch.ops import table_sweep

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

    def tail_grids(dtype, N, D, F, p):
        """fused_block_tail_bwd at grids of 1, 7 and the default blocks: dx
        and do bit-equal across the grids, every output bit-equal between
        two calls on one grid, the weight gradients within the fp32 band
        across grids (their per-block partials regroup)."""
        ts, dy = tail_args(dtype, N, D, F)
        names = ("dx", "do", "dwout", "dbout", "dwn1", "dw1", "db1", "dw2", "db2", "dwn2")
        runs = {}
        for blocks in (None, 1, 7):
            first = fused_block_tail_bwd(*ts, dy, p, SEED, blocks=blocks)
            again = fused_block_tail_bwd(*ts, dy, p, SEED, blocks=blocks)
            for i, name in enumerate(names):
                assert torch.equal(first[i], again[i]), f"{name} changed between two calls"
            runs[blocks] = first
        torch.cuda.synchronize()
        for blocks in (1, 7):
            for i, name in enumerate(names):
                if i < 2:
                    assert torch.equal(runs[blocks][i], runs[None][i]), \
                        f"{name} moved with the grid ({blocks})"
                else:
                    close(f"{name} at {blocks} blocks", "f32", runs[blocks][i], runs[None][i])

    def tail_autograd(dtype, N, D, F, p):
        """fused_block_tail's backward is the kernel, each gradient in its
        input's dtype."""
        ts, dy = tail_args(dtype, N, D, F)
        leaves = [a.detach().requires_grad_() for a in ts]
        before = fused_block_tail_bwd.launches
        fused_block_tail(*leaves, dropout_p=p, seed=SEED).backward(dy)
        torch.cuda.synchronize()
        assert fused_block_tail_bwd.launches == before + 1
        want = fused_block_tail_bwd_reference(*ts, dy, p, SEED)
        for i, t in enumerate(leaves):
            assert t.grad.dtype == t.dtype, (i, t.grad.dtype)
            close(f"grad {i}", dtype, t.grad, want[i].to(t.dtype), activation=i < 2)

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

    def attention_bwd_grids(B, K, D, H, p):
        """Both bf16 backwards at grids of 1, 7 and the default blocks: the
        activation gradients bit-equal across the grids, every output
        bit-equal between two calls on one grid, the weight gradients within
        the fp32 band across grids (their per-block partials regroup), and
        the default grid within the bf16 bands of the plain versions."""
        (x, w, b, bias, _), do = attn_args("bf16", B, K, D, H)
        (q, k, v, mbias, _), mdo = mha_args("bf16", B, K, D, H)
        for fn, args, plain, n_act in (
                (fused_mha_qkv_bwd, (x, w, b, bias, do, H, p, SEED),
                 fused_mha_qkv_bwd_reference, 1),
                (fused_mha_bwd, (q, k, v, mbias, mdo, H, p, SEED), fused_mha_bwd_reference, 3)):
            runs = {}
            for blocks in (None, 1, 7):
                first = fn(*args, blocks=blocks)
                again = fn(*args, blocks=blocks)
                for i, (u, w_) in enumerate(zip(first, again)):
                    assert torch.equal(u, w_), f"output {i} changed between two calls"
                runs[blocks] = first
            torch.cuda.synchronize()
            for blocks in (1, 7):
                for i, (u, w_) in enumerate(zip(runs[None], runs[blocks])):
                    if i < n_act:
                        assert torch.equal(u, w_), f"activation {i} moved with the grid ({blocks})"
                    else:
                        close(f"weight gradient {i} at {blocks} blocks", "f32", w_, u)
            for i, (u, ref) in enumerate(zip(runs[None], plain(*args))):
                close(f"output {i}", "bf16", u, ref, activation=i < n_act)

    def forward_grids(B, K, D, H, p, unit=True):
        """Both bf16 forwards at grids of 1, 7 and the default blocks, on
        the kernel ``fwd_unit_kernel`` picks for the shape (the warp-unit
        one unless ``unit`` is False): the output bit-equal across the
        grids and between two calls, the default grid within the bf16 band
        of the plain version; ``fused_mha_qkv``'s bit-equal to the tiled
        CUDA-core kernel's (its FFMA chains run in that kernel's order)."""
        fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
        assert fa.fwd_unit_kernel(torch.bfloat16, K, D, H) is unit, (K, D, H)
        (x, w, b, bias, _), _ = attn_args("bf16", B, K, D, H)
        (q, k, v, mbias, _), _ = mha_args("bf16", B, K, D, H)
        for name, fn, args, plain, counter in (
                ("fused_mha_qkv", fa.fused_mha_qkv_fwd, (x, w, b, bias, H, p, SEED),
                 fused_mha_qkv_reference, fused_mha_qkv),
                ("fused_mha", fa.fused_mha_fwd, (q, k, v, mbias, H, p, SEED),
                 fused_mha_reference, fused_mha)):
            before = counter.launches
            runs = {blocks: fn(*args, blocks=blocks) for blocks in (None, 1, 7)}
            again = fn(*args)
            torch.cuda.synchronize()
            assert counter.launches == before + 4, name
            assert torch.equal(runs[None], again), f"{name} changed between two calls"
            for blocks in (1, 7):
                assert torch.equal(runs[None], runs[blocks]), f"{name} moved with the grid"
            close(name, "bf16", runs[None], plain(*args))
        assert torch.equal(fa.fused_mha_qkv_fwd(x, w, b, bias, H, p, SEED),
                           qkv_fwd_tiled(x, w, b, bias, H, p)), \
            "fused_mha_qkv's warp-unit kernel differs from the tiled one"

    def qkv_fwd_tiled(x, w, b, bias, H, p):
        """``fused_mha_qkv``'s forward on its tiled CUDA-core kernel, by the
        C entry point (``unit_kernel`` 0), at a shape the wrapper sends to
        the warp-unit kernel."""
        from tossctr_tpu_torch.ops import _build
        from tossctr_tpu_torch.ops.dropout import kernel_args

        fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
        B, K, D = x.shape
        out = torch.empty_like(x)
        lib = _build.load_library("fused_mha_qkv")
        rc = lib.tossctr_fused_mha_qkv_fwd(
            *(t.data_ptr() for t in (x, w, b, bias)), out.data_ptr(), B, K, D, H,
            fa.attention_scale(D // H), *kernel_args(p, SEED), 0, 0, _build.DTYPE_CODES[x.dtype],
            x.device.index, _build.stream_of(x))
        _build.check_launch(lib, rc, "fused_mha_qkv")
        return out

    def forward_refusals():
        """The warp-unit forwards refuse unaligned tensors before any
        launch (no other kernel takes over); the tiled forward refuses a K
        whose query tile fits no block."""
        fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
        B, K, D, H = 3, 64, 64, 8
        (x, w, b, bias, _), _ = attn_args("bf16", B, K, D, H)
        (q, k, v, mbias, _), _ = mha_args("bf16", B, K, D, H)
        off = torch.zeros(B * K * D + 1, dtype=torch.bfloat16, device=dev)[1:].view(B, K, D)
        off.copy_(x)  # contiguous, 2 bytes past a 16-byte boundary
        before = (fused_mha_qkv.launches, fused_mha.launches)
        with pytest.raises(RuntimeError):
            fa.fused_mha_qkv_fwd(off, w, b, bias, H)
        with pytest.raises(RuntimeError):
            fa.fused_mha_fwd(q, off, v, mbias, H)
        wide = 4000  # (K, D) q, k, v of one row exceed a block's shared memory
        big = torch.zeros(1, wide, D, dtype=torch.bfloat16, device=dev)
        with pytest.raises(RuntimeError):
            fa.fused_mha_fwd(big, big, big, torch.zeros(wide, wide, dtype=big.dtype, device=dev),
                             H)
        assert (fused_mha_qkv.launches, fused_mha.launches) == before

    def mma_refusals():
        """The bf16 tensor-core backwards refuse the head widths they do not
        take at K <= 64, before any launch."""
        for K, D, H in ((12, 64, 2), (12, 24, 4), (12, 64, 64), (100, 64, 2)):  # dh 32, 6, 1, 32
            (x, w, b, bias, _), do = attn_args("bf16", 3, K, D, H)
            (q, k, v, mbias, _), mdo = mha_args("bf16", 3, K, D, H)
            before = (fused_mha_qkv_bwd.launches, fused_mha_bwd.launches)
            with pytest.raises(ValueError):
                fused_mha_qkv_bwd(x, w, b, bias, do, H)
            with pytest.raises(ValueError):
                fused_mha_bwd(q, k, v, mbias, mdo, H)
            assert (fused_mha_qkv_bwd.launches, fused_mha_bwd.launches) == before
        (x, w, b, bias, _), do = attn_args("bf16", 3, 12, 64, 16)  # dh 4: dWqkv too wide
        with pytest.raises(ValueError):
            fused_mha_qkv_bwd(x, w, b, bias, do, 16)

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

    def ffn_grids(dtype, N, D, F, p):
        """fused_ffn_bwd at grids of 1, 7 and the default blocks: dx
        bit-equal across the grids, the weight gradients bit-equal between
        two calls on one grid and within the fp32 band across grids (their
        per-block partials regroup)."""
        (x, w1, b1, w2, _), dy = ffn_args(dtype, N, D, F)
        runs = {}
        for blocks in (None, 1, 7):
            first = fused_ffn_bwd(x, w1, b1, w2, dy, p, SEED, blocks=blocks)
            again = fused_ffn_bwd(x, w1, b1, w2, dy, p, SEED, blocks=blocks)
            for i, name in enumerate(("dx", "dw1", "db1", "dw2", "db2")):
                assert torch.equal(first[i], again[i]), f"{name} changed between two calls"
            runs[blocks] = first
        torch.cuda.synchronize()
        for blocks in (1, 7):
            assert torch.equal(runs[blocks][0], runs[None][0]), f"dx moved with the grid ({blocks})"
            for i, name in enumerate(("dw1", "db1", "dw2", "db2"), 1):
                close(f"{name} at {blocks} blocks", "f32", runs[blocks][i], runs[None][i])

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

    def fm_grids(dtype, *shape):
        """The pair at a grid of a few blocks: out and dz bit-equal to the
        default grid's, dU within 1e-5 (its per-block partials regroup),
        dV bit-equal (its row chunks do not depend on the grid), all
        within the bands of the plain versions."""
        z, U, V, g = fm_args(dtype, *shape)
        runs = {b: (fm_cross_pallas_fwd_only(z, U, V, blocks=b),
                    *fm_cross_pallas_bwd(z, U, V, g, blocks=b)) for b in (None, 1, 3)}
        torch.cuda.synchronize()
        want = (fm_cross_pallas_reference(z, U, V), *fm_cross_pallas_bwd_reference(z, U, V, g))
        for blocks, got in runs.items():
            for i, name in enumerate(("out", "dz", "dU", "dV")):
                close(f"{name} at {blocks} blocks", dtype, got[i], want[i], activation=i < 2)
                if i == 2:
                    close(f"dU at {blocks} blocks", "f32", got[i], runs[None][i])
                else:
                    assert torch.equal(got[i], runs[None][i]), f"{name} at {blocks} blocks"

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
        for dtype in ("f32", "bf16"):
            (x, w1, b1, w2, b2), dy = ffn_args(dtype, 8, 68, 40)
            with pytest.raises(ValueError):
                fused_ffn(x, w1, b1, w2, b2)  # D > 64
            with pytest.raises(ValueError):
                fused_ffn_bwd(x, w1, b1, w2, dy)  # D > 64
        z, U, V, g = fm_args("f32", 4, 8, 68, 2, 4, 8)
        with pytest.raises(ValueError):
            fm_cross_pallas(z, U, V)  # D > 64
        z, U, V, g = fm_args("f32", 4, 8, 16, 12, 12, 8)
        with pytest.raises(ValueError):
            fm_cross_pallas_bwd(z, U, V, g)  # H*R > 128

    def sweep(dtype, V, D, n_tables, ids, ddtype="f32"):
        """sweep_rows_add against its plain version on copies of the same
        tables: rows within one ulp, untouched rows unchanged, and a second
        run from the same tables repeats the first bit for bit; the deltas
        fp32 or (``ddtype``) bf16."""
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        ddt = torch.bfloat16 if ddtype == "bf16" else torch.float32
        gen = torch.Generator().manual_seed(6)
        tables = [torch.randn(V, D, generator=gen).to(dev, dt) for _ in range(n_tables)]
        deltas = [torch.randn(ids.numel(), D, generator=gen).mul(0.05).to(dev, ddt)
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

    def sweep_edges():
        """sweep_rows_add with no ids (no launch, tables unchanged) and one;
        deltas the kernel does not take raise before a launch: fp16 or
        fp64, fp32 and bf16 mixed, bf16 into an fp32 table, a transposed
        view, a view one element off its alignment."""
        table = torch.randn(300, 8, device=dev).to(torch.bfloat16)
        before = sweep_rows_add.launches
        got = table.clone()
        sweep_rows_add([got], torch.zeros(0, dtype=torch.long, device=dev),
                       [torch.zeros(0, 8, device=dev)])
        assert torch.equal(got, table) and sweep_rows_add.launches == before
        one = torch.tensor([123], device=dev)
        d1 = torch.randn(1, 8, device=dev)
        got, want = table.clone(), table.clone()
        sweep_rows_add([got], one, [d1])
        sweep_rows_add_reference([want], one, [d1])
        assert torch.equal(got, want) and sweep_rows_add.launches == before + 1
        ids = torch.randint(0, 300, (40,), device=dev)
        two = [table.clone(), table.clone()]
        buf = torch.randn(40 * 8 + 1, device=dev)
        for tabs, ds, exc in (
                ([table], [torch.randn(40, 8, device=dev).half()], TypeError),
                ([table], [torch.randn(40, 8, device=dev).double()], TypeError),
                (two, [torch.randn(40, 8, device=dev),
                       torch.randn(40, 8, device=dev).to(torch.bfloat16)], TypeError),
                ([table.float()], [torch.randn(40, 8, device=dev).to(torch.bfloat16)],
                 TypeError),
                ([table], [torch.randn(8, 40, device=dev).t()], ValueError),
                ([table], [buf[1:].view(40, 8)], ValueError)):
            with pytest.raises(exc):
                sweep_rows_add(tabs, ids, ds)
        assert sweep_rows_add.launches == before + 1

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

    def table_sweeps(V, D, W, blocks):
        """dense_sweep and sparse_sweep against their plain versions on
        copies of one bf16 table, bit for bit, one launch each (none for
        an empty list)."""
        gen = torch.Generator().manual_seed(8)
        table = torch.randn(V, D, generator=gen).mul(0.01).to(dev, torch.bfloat16)
        got, want = table.clone(), table.clone()
        before = table_sweep.dense_sweep.launches
        table_sweep.dense_sweep(got, W)
        torch.cuda.synchronize()
        assert table_sweep.dense_sweep.launches == before + 1
        table_sweep.dense_sweep_reference(want, W)
        assert torch.equal(got, want), "dense_sweep"
        blocks = torch.tensor(blocks, dtype=torch.int32, device=dev)
        got, want = table.clone(), table.clone()
        before = table_sweep.sparse_sweep.launches
        table_sweep.sparse_sweep(got, W, blocks)
        torch.cuda.synchronize()
        assert table_sweep.sparse_sweep.launches == before + (1 if blocks.numel() else 0)
        table_sweep.sparse_sweep_reference(want, W, blocks)
        assert torch.equal(got, want), "sparse_sweep"
        if blocks.numel() > 1:  # out of order: refused before a launch, as the plain version
            before = table_sweep.sparse_sweep.launches
            with pytest.raises(ValueError, match="ascending"):
                table_sweep.sparse_sweep(got, W, blocks.flip(0))
            blocks[0] = blocks[-1] + 1  # the list swept above, changed in place
            with pytest.raises(ValueError, match="ascending"):
                table_sweep.sparse_sweep(got, W, blocks)
            assert table_sweep.sparse_sweep.launches == before

    def mask_dumps(B, K, H, N, F, p, seed):
        before = (dropout_masks.dump_attention_keep.launches,
                  dropout_masks.dump_ffn_keep.launches)
        a = dropout_masks.dump_attention_keep(B, K, H, p, seed, dev)
        f = dropout_masks.dump_ffn_keep(N, F, p, seed, dev)
        torch.cuda.synchronize()
        assert (dropout_masks.dump_attention_keep.launches,
                dropout_masks.dump_ffn_keep.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(a, dropout_masks.attention_keep(B, K, H, p, seed, device=dev)), \
            "attention mask"
        assert torch.equal(f, dropout_masks.ffn_keep(N, F, p, seed, device=dev)), "ffn mask"

    def grid_invariance(dtype, B, K, D, H, F, blocks):
        """The persistent kernels at ``blocks`` blocks against their default
        grid: outputs and activation gradients bit-equal, weight gradients
        within 1e-5 of the largest."""
        fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
        ff = importlib.import_module("tossctr_tpu_torch.ops.fused_ffn")
        (x, w, b, bias, _), do = attn_args(dtype, B, K, D, H)
        q, k, v = (torch.randn_like(x.float()).to(x.dtype) for _ in range(3))
        tail, dy = tail_args(dtype, B * K, D, F)
        cases = (
            (lambda **kw: (fa.fused_mha_qkv_fwd(x, w, b, bias, H, P_DROP, SEED, **kw),), 1),
            (lambda **kw: (fa.fused_mha_fwd(q, k, v, bias, H, P_DROP, SEED, **kw),), 1),
            (lambda **kw: fa.fused_mha_qkv_bwd(x, w, b, bias, do, H, P_DROP, SEED, **kw), 1),
            (lambda **kw: fa.fused_mha_bwd(q, k, v, bias, do, H, P_DROP, SEED, **kw), 3),
            (lambda **kw: ff.fused_block_tail_bwd(*tail, dy, P_DROP, SEED, **kw), 2),
            (lambda **kw: ff.fused_ffn_bwd(tail[0], tail[5], tail[6], tail[7], dy, P_DROP, SEED,
                                           **kw), 1),
        )
        for fn, n_act in cases:
            for i, (u, w_) in enumerate(zip(fn(), fn(blocks=blocks))):
                if i < n_act:
                    assert torch.equal(u, w_), f"an activation moved with the grid ({i})"
                else:
                    close(f"weight gradient {i}", "f32", w_, u)

    checks = Checks()
    for V, D, W, blocks in ((4096, 64, 1024, [0, 3, 7, 7, 7]),  # whole blocks; padding repeats
                            (4103, 64, 1024, [1, 16, 16, 16]),  # a partial last block, listed
                            (5000, 128, 4096, [2, 9, 40]),  # 9 whole blocks: 40 is outside
                            (4096, 64, 16384, []),  # an empty list
                            (37, 16, 1024, [0]),  # one partial block
                            (4099, 6, 1024, [0, 1, 1]),  # 24,594 elements: not a multiple of 8
                            # 7,813 items of 8192 elements a dense sweep
                            (1_000_003, 64, 1024, list(range(0, 3907, 3)) + [3906, 3906])):
        listed = blocks if len(blocks) < 8 else f"{len(blocks)} blocks"
        checks.run(f"table sweeps V={V} D={D} W={W} {listed}", table_sweeps, V, D, W, blocks)
    for B, K, H, N, F, p, seed in ((64, 12, 8, 128, 256, 0.3, 1234),
                                   (9, 64, 8, 577, 384, 0.1, 2**31 - 2),
                                   (5, 13, 4, 37, 40, 0.15, 7)):
        checks.run(f"mask dumps B={B} K={K} H={H} N={N} F={F}", mask_dumps, B, K, H, N, F, p,
                   seed)
    for dtype in ("f32", "bf16"):
        checks.run(f"grid invariance {dtype} K=64", grid_invariance, dtype, 300, 64, 64, 8, 384,
                   5)
        checks.run(f"grid invariance {dtype} K=120", grid_invariance, dtype, 40, 120, 64, 8, 384,
                   3)
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
                for ddtype in ("f32", "bf16") if dtype == "bf16" else ("f32",):
                    checks.run(f"sweep {dtype} {kind} tables={n_tables} D={D} deltas {ddtype}",
                               sweep, dtype, 5000, D, n_tables, sweep_ids(kind, 5000, 4000),
                               ddtype)
    # the hot id over 31 pieces, N = 4000 and 4001 not multiples of the piece
    checks.run("sweep bf16 hot N=4001", sweep, "bf16", 5000, 64, 1, sweep_ids("hot", 5000, 4001))
    checks.run("sweep edges", sweep_edges)
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
            # the flagship's widths; ragged N and F; cfgs/synth_small.yaml's
            # width; several persistent walks with a ragged end (132 SMs x 64
            # rows x 3 + 37); F too wide for the forward's shared memory (its
            # weights in two panels)
            for N, D, F in ((1000, 64, 384), (37, 16, 40), (130, 64, 100), (200, 32, 64),
                            (132 * 64 * 3 + 37, 64, 384), (300, 64, 1024)):
                checks.run(f"ffn {dtype} p={p} N={N} D={D} F={F}", ffn, dtype, N, D, F, p)
        for N, D, F in ((132 * 64 * 3 + 37, 64, 384), (200, 32, 64), (37, 16, 40)):
            checks.run(f"ffn grids {dtype} N={N} D={D} F={F}", ffn_grids, dtype, N, D, F, P_DROP)
        checks.run(f"mha autograd {dtype}", mha_autograd, dtype, 7, 12, 64, 8, P_DROP)
        checks.run(f"mha autograd {dtype} K=60", mha_autograd, dtype, 7, 60, 64, 8, P_DROP)
        checks.run(f"attention autograd {dtype} K=12", attention_autograd, dtype, 7, 12, 64, 8,
                   P_DROP)
        checks.run(f"ffn autograd {dtype}", ffn_autograd, dtype, 130, 64, 384, P_DROP)
        # (B, F, D, H, R, P): the flagship's QNN at a ragged batch, a ragged
        # shape of every dimension, a single row (R = 4: the CUDA-core
        # pair in bf16 too); then the bf16 tensor-core pair's edges: the
        # flagship at 8192 + 37 rows, F = 8, 24 and 17, R = 8 with H*R =
        # 128 and P = 12, R = 32 at D = 48 and P = 20, F = 5 (one m-tile)
        # at D = 24 with H*R = 24 (both padded)
        for shape in ((67, 200, 64, 6, 16, 192), (5, 13, 10, 3, 5, 7), (1, 8, 16, 2, 4, 8),
                      (8192 + 37, 200, 64, 6, 16, 192), (9, 8, 64, 6, 16, 192),
                      (13, 24, 32, 4, 16, 32), (37, 40, 16, 16, 8, 12), (29, 24, 48, 4, 32, 20),
                      (19, 17, 64, 2, 8, 36), (3, 5, 24, 3, 8, 8)):
            checks.run(f"fm cross {dtype} {shape}", fm_cross, dtype, *shape)
        for shape in ((67, 200, 64, 6, 16, 192), (37, 40, 16, 16, 8, 12)):
            checks.run(f"fm cross grids {dtype} {shape}", fm_grids, dtype, *shape)
        checks.run(f"fm cross autograd {dtype}", fm_cross_autograd, dtype, 9, 16, 16, 2, 4, 8)
    # the block tail pair (bf16 on the tensor cores, fp32 on the CUDA
    # cores) at every padded width (D = 16, 24 -> 32, 48, 64), hidden
    # widths that are and are not multiples of the 64-column chunk, rows
    # that are not multiples of the forward's 16-row or the backward's
    # 128-row tiles (and several persistent walks: 132 SMs x 128 rows x 2
    # + 37), F = 1024 (the weights in panels), across grids and through
    # autograd
    for dtype in ("f32", "bf16"):
        for p in (0.0, P_DROP):
            for N, D, F in ((1000, 16, 64), (37, 24, 200), (130, 48, 384), (777, 64, 200),
                            (132 * 128 * 2 + 37, 64, 384), (300, 64, 1024)):
                tag = f"{dtype} p={p} N={N} D={D} F={F}"
                checks.run(f"block tail {tag}", block_tail, dtype, N, D, F, p)
                checks.run(f"block tail bwd {tag}", block_tail_bwd, dtype, N, D, F, p)
        for N, D, F in ((132 * 128 * 2 + 37, 64, 384), (200, 24, 64), (37, 16, 200)):
            checks.run(f"block tail grids {dtype} N={N} D={D} F={F}", tail_grids, dtype, N, D, F,
                       P_DROP)
        checks.run(f"block tail autograd {dtype}", tail_autograd, dtype, 130, 64, 384, P_DROP)
    # the bf16 backwards' tensor-core kernels (K <= 128: queries and keys
    # padded to 64 or 128) at every head width they take (dh 4, 8, 12, 16:
    # 8-byte pieces, heads padded to 8 and 16 columns), a small odd shape,
    # the flagship's K = 60 and 64, the first K of the wider form, the K =
    # 120 config's, its end, and the CUDA-core ones above, across grids
    for p in (0.0, P_DROP):
        for B, K, D, H in ((7, 12, 64, 8), (9, 60, 64, 8), (6, 64, 64, 8), (5, 33, 32, 8),
                           (5, 60, 48, 4), (4, 64, 64, 4), (3, 17, 32, 2), (4, 65, 64, 8),
                           (3, 128, 64, 8), (4, 100, 32, 2), (3, 97, 48, 4), (3, 121, 16, 4)):
            tag = f"bf16 p={p} B={B} K={K} D={D} H={H}"
            checks.run(f"attention bwd mma {tag}", attention_bwd, "bf16", B, K, D, H, p)
            checks.run(f"mha mma {tag}", mha, "bf16", B, K, D, H, p)
        for B, K in ((7, 12), (9, 60), (6, 64), (4, 120), (3, 152)):
            checks.run(f"attention bwd grids bf16 p={p} B={B} K={K}", attention_bwd_grids, B, K,
                       64, 8, p)
    # the bf16 backwards' tensor-core kernels at K padded to 160 (10 warps,
    # one a query tile; dbias in device memory; the qkv kernel's Wqkv and x
    # copied again each row) at every head width they take (dh 4, 8, 12,
    # 16 at D = 32, 48, 64; heads padded to 48 and 64 columns), the first
    # K of the form, a ragged one, the K = 148 config's 152 and the form's
    # end, across grids of 1, 7 and the default with rows enough for several
    # walks; then the key-tiled CUDA-core backwards at the bf16 shapes they
    # keep: K = 161, and at K = 152 16 heads of 4 (padded to 128 columns),
    # which go to them by shape, not refused
    fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
    for p in (0.0, P_DROP):
        for B, K, D, H in ((3, 129, 64, 8), (3, 137, 48, 4), (5, 152, 64, 8), (3, 152, 32, 8),
                           (3, 160, 64, 4), (3, 160, 48, 6), (3, 160, 32, 2)):
            tag = f"bf16 p={p} B={B} K={K} D={D} H={H}"
            assert fa.bwd_mma_kernel(torch.bfloat16, K, D, H, True), tag
            assert fa.bwd_mma_kernel(torch.bfloat16, K, D, H, False), tag
            checks.run(f"attention bwd mma {tag}", attention_bwd, "bf16", B, K, D, H, p)
            checks.run(f"mha mma {tag}", mha, "bf16", B, K, D, H, p)
        for B, K in ((20, 129), (20, 152), (20, 160)):
            checks.run(f"attention bwd grids bf16 p={p} B={B} K={K}", attention_bwd_grids, B, K,
                       64, 8, p)
        for B, K, D, H in ((3, 161, 64, 8), (3, 152, 64, 16)):
            tag = f"bf16 p={p} B={B} K={K} D={D} H={H}"
            assert not fa.bwd_mma_kernel(torch.bfloat16, K, D, H, False), tag
            checks.run(f"attention bwd tiled {tag}", attention_bwd, "bf16", B, K, D, H, p)
            checks.run(f"mha tiled {tag}", mha, "bf16", B, K, D, H, p)
    checks.run("attention autograd bf16 K=152", attention_autograd, "bf16", 3, 152, 64, 8, P_DROP)
    checks.run("mha autograd bf16 K=152", mha_autograd, "bf16", 3, 152, 64, 8, P_DROP)
    # the bf16 forwards' warp-unit kernels (K <= 160: K padded to 64, 128
    # or 160) at every head width they take (dh 4, 8, 12, 16 at D = 32, 48,
    # 64), the flagship's K = 60 and 64, ragged K, each padding's ends, the
    # K = 120 and 152 configs'; and the bf16 shapes the tiled kernels keep:
    # a head width of 32, 16 heads of 4 (padded to 128 columns), K = 161
    for p in (0.0, P_DROP):
        for B, K, D, H in ((7, 12, 64, 8), (5, 13, 32, 8), (9, 60, 64, 8), (6, 64, 64, 4),
                           (5, 77, 48, 4), (6, 80, 32, 2), (4, 120, 64, 8), (4, 128, 48, 4),
                           (3, 129, 64, 8), (3, 152, 64, 8), (3, 152, 32, 8), (3, 160, 64, 4)):
            checks.run(f"forward grids bf16 p={p} B={B} K={K} D={D} H={H}", forward_grids, B,
                       K, D, H, p)
        for B, K, D, H in ((5, 64, 64, 2), (5, 64, 64, 16), (3, 161, 64, 8)):
            checks.run(f"forward grids tiled bf16 p={p} B={B} K={K} D={D} H={H}",
                       forward_grids, B, K, D, H, p, False)
    checks.run("forwards refuse unaligned tensors", forward_refusals)
    checks.run("mma kernels refuse head widths", mma_refusals)
    checks.run("kernels refuse what they do not take", kernels_refuse_what_they_do_not_take)
    checks.done()
