"""The port's FM-cross kernel path against the JAX package's Pallas kernel.

* ``fm_cross_pallas_reference`` / ``fm_cross_pallas_bwd_reference`` (the
  plain PyTorch versions the CUDA kernels are checked against on the
  card) against ``tossctr_tpu`` ``fm_cross_pallas`` and ``jax.vjp`` of
  it in interpret mode, on the same numpy inputs, with a batch that is
  not a multiple of the Pallas blocks (forward block 4, backward block
  8: a partial last block on both):

  - fp32 within 1e-5 of each output's largest magnitude (the same
    arithmetic in another summation order);
  - bf16 out and dz within 3 bf16 ulps of the largest output (one ulp at
    each rounding point where the fp32 sums land apart); bf16 dU and dV
    (the Pallas custom_vjp returns them in U's and V's bf16) within 1e-2
    of the largest magnitude, one bf16 ulp of a term of their sums.

* the autograd wrapper on a CPU tensor runs exactly the plain versions;
* ``fm_mma_kernel``, the rule by which the wrapper sends a shape to the
  tensor-core kernels or the CUDA-core ones on the card: bf16 only, D and
  R multiples of 8, P of 4, both kernels' shared memory (``fm_mma_smem``,
  the flagship's 108,688 and 227,984 bytes) within a block's;
* ``QNNAlpha``'s dispatch: block grouping takes ``fm_cross_blocked``,
  ``use_pallas`` with F % 8 == 0 the kernel path, F % 8 != 0 the plain
  einsum path;
* the port's ``CTRModel`` with ``model.extra.use_pallas_fm`` against the
  JAX package's on converted parameters, fp32: logits within 1e-4, and
  the gradients of U, V and the numeric, mask and categorical feature
  embeddings of sum(w * logits) within 1e-4 of each tensor's largest
  magnitude.

One test item (see ``_torch_helpers``).
"""

import numpy as np

import _torch_helpers as H

WGRAD_BAND_BF16 = 1e-2


def fm_cfg_dict():
    """The tiny config with five categorical columns (F = 1 + 5 + 5 + 5 =
    16 QNN tokens, so the kernel path is taken) and one encoder layer."""
    return H.tiny_cfg_dict("none", data=H.FM_CATS, sequence={"tfm": {"n_layers": 1}},
                           model={"extra": {"use_pallas_fm": True}})


def _close(name, dtype, got, want, activation=True):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    if dtype == "f32":
        tol = 1e-5 * max(top, 1.0)
    elif activation:
        tol = H.bf16_band(want)
    else:
        tol = WGRAD_BAND_BF16 * top
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs err {err} > {tol} (largest |want| {top})"


def test_fm_cross_matches_pallas():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.ops.pallas_kernels import fm_cross_pallas as jax_fm_cross_pallas
    from tossctr_tpu_torch.models import qnn_alpha
    from tossctr_tpu_torch.ops import (
        fm_cross_pallas,
        fm_cross_pallas_bwd_reference,
        fm_cross_pallas_reference,
    )
    from tossctr_tpu_torch.ops.fm_cross import fm_mma_kernel, fm_mma_smem

    def inputs(B, F, D, Hh, R, P, seed=2):
        rng = np.random.default_rng(seed)
        return (rng.normal(0, 1, (B, F, D)).astype(np.float32),
                rng.normal(0, 0.3, (Hh, D, R)).astype(np.float32),
                rng.normal(0, 0.3, (Hh, R, P)).astype(np.float32),
                rng.normal(0, 1, (B, Hh * P)).astype(np.float32))

    def np32(t):
        return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)

    def kernel_pair(dtype, B, F, D, Hh, R, P):
        z, U, V, g = inputs(B, F, D, Hh, R, P)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        j = [jnp.asarray(a, jdt) for a in (z, U, V, g)]
        t = [torch.from_numpy(a).to(tdt) for a in (z, U, V, g)]
        jout, jgrads = H.jitted_vjp(lambda z_, u_, v_: jax_fm_cross_pallas(z_, u_, v_, 4, True),
                                    j[:3], j[3])
        _close("out", dtype, np32(fm_cross_pallas_reference(*t[:3])), np32(jout))
        tgrads = fm_cross_pallas_bwd_reference(*t)
        for i, name in enumerate(("dz", "dU", "dV")):
            got = tgrads[i] if i == 0 else tgrads[i].to(tdt)  # as the custom_vjp returns them
            _close(name, dtype, np32(got), np32(jgrads[i]), activation=i == 0)

        # the autograd wrapper runs the same plain forward and backward
        leaves = [a.clone().requires_grad_() for a in t[:3]]
        out = fm_cross_pallas(*leaves)
        assert torch.equal(out, fm_cross_pallas_reference(*t[:3]))
        out.backward(t[3])
        for leaf, want in zip(leaves, tgrads):
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, want.to(leaf.dtype))

    def mma_rule():
        bf, f32 = torch.bfloat16, torch.float32
        assert fm_mma_smem(64, 6, 16, 192) == (108688, 227984)  # the flagship's QNN
        for D, Hh, R, P, want in (
            (64, 6, 16, 192, True),  # the flagship
            (16, 16, 8, 12, True),  # R = 8, H*R = 128, P not a multiple of 8
            (48, 4, 32, 20, True),  # R = 32, D = 48
            (8, 2, 8, 4, True),  # the smallest
            (10, 3, 5, 7, False),  # ragged D, R and P: the CUDA-core pair
            (16, 2, 4, 8, False),  # R = 4
            (24, 2, 8, 6, False),  # P % 4 != 0
            (12, 2, 8, 8, False),  # D % 8 != 0
            (64, 16, 8, 192, False),  # the g tile and V past a block's shared memory
        ):
            assert fm_mma_kernel(bf, D, Hh, R, P) is want, (D, Hh, R, P)
            assert not fm_mma_kernel(f32, D, Hh, R, P)

    def dispatch():
        calls = []
        real = {n: getattr(qnn_alpha, n)
                for n in ("fm_cross_pallas", "fm_cross_multihead", "fm_cross_blocked")}

        def spy(n):
            def f(*a, **k):
                calls.append(n)
                return real[n](*a, **k)
            return f

        try:
            for n in real:
                setattr(qnn_alpha, n, spy(n))
            for F, grouping, use_pallas, want in (
                (16, "all", True, "fm_cross_pallas"),
                (15, "all", True, "fm_cross_multihead"),
                (16, "all", False, "fm_cross_multihead"),
                (16, "block", True, "fm_cross_blocked"),
            ):
                torch.manual_seed(0)
                m = qnn_alpha.QNNAlpha(F, 8, heads=2, rank=4, proj_dim=6, mlp_hidden=(8,),
                                       pair_grouping=grouping, block_slices={"a": (0, 5),
                                                                             "b": (5, F)},
                                       use_pallas=use_pallas)
                for p in m.parameters():
                    torch.nn.init.normal_(p, 0, 0.1)
                calls.clear()
                with torch.no_grad():
                    m(torch.randn(4, F, 8), torch.float32)
                assert calls[:1] == [want], (F, grouping, use_pallas, calls)
        finally:
            for n, f in real.items():
                setattr(qnn_alpha, n, f)

    def model_vs_jax():
        d = fm_cfg_dict()
        batch = H.make_batch(d, B=8, seed=1)
        model, variables = H.jax_model_and_variables(d, batch)
        assert model.use_pallas_fm
        port = H.port_model(d, variables)
        assert port.qnn.use_pallas
        w = np.random.default_rng(3).normal(0, 1, 8).astype(np.float32)

        def jloss(params):
            z, _, _ = model.apply({"params": params}, batch, deterministic=True)
            return jnp.sum(z * w), z

        (_, jz), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
        z, _, _ = port(H.torch_batch(batch))
        (z * torch.from_numpy(w)).sum().backward()
        _close("logits", "f32", z.detach().numpy(), np.asarray(jz))
        tol = 1e-4
        grads = dict(port.named_parameters())
        names = ["qnn.U", "qnn.V", "num_embed.weight", "num_embed.bias", "mask_embed.weight",
                 *[n for n in grads if n.startswith("cat_embed.")]]
        for name in names:
            want = np.asarray(_leaf(jg, name.split(".")), np.float32)
            got = grads[name].grad.numpy()
            top = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            assert top > 0 and err <= tol * top, f"grad {name}: {err} > {tol} x {top}"

    checks = H.Checks()
    with H.torch_threads():
        for dtype in ("f32", "bf16"):
            checks.run(f"kernel pair {dtype} B=10", kernel_pair, dtype, 10, 16, 16, 2, 4, 8)
        checks.run("kernel pair f32 F=13 D=12 H=3 R=5 P=7", kernel_pair, "f32", 9, 13, 12, 3, 5, 7)
        checks.run("tensor-core routing rule", mma_rule)
        checks.run("QNNAlpha dispatch", dispatch)
        checks.run("CTRModel with use_pallas_fm vs JAX", model_vs_jax)
    checks.done()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
