"""The port's attention plain versions against the Pallas kernels at the
K of the repo's larger-K configs: K = 80 (``cfgs/dare_base_tpu.yaml``),
120 (``cfgs/v3_k120_s1_tpu.yaml``) and 152 (``cfgs/v3_k148_s1_tpu.yaml``,
top_k 148 padded to a multiple of 8).  The card's kernels tile the
queries (forwards) and the keys (backwards) above K = 64; their plain
versions, which the card holds them against, must agree with the Pallas
kernels there.

``fused_mha_qkv_reference`` / ``fused_mha_qkv_bwd_reference`` and
``fused_mha_reference`` / ``fused_mha_bwd_reference`` are held against
``tossctr_tpu`` ``fused_mha_qkv`` and ``fused_mha`` and ``jax.vjp`` of
them, in interpret mode with ``dropout_impl="hash"``, on the same numpy
inputs: B = 2 in batch blocks of 1 (so the mask's absolute row offsets
are exercised), D = 16, 2 heads, the last 4 key columns masked with
-1e9 as DARE's pad columns are.  Each function runs at each K once,
forward and backward, and across the three K in fp32 and in bf16 and
with dropout off and at p = 0.2 (each interpret-mode run compiles anew,
so the settings rotate over the K rather than multiply), within the
bands of test_torch_fused_mha.py: fp32 1e-5 of each output's largest magnitude;
bf16 activations (out, dx, dq, dk, dv) 3 bf16 ulps of the largest, the
bf16 weight gradients and dbias 1e-2 of their largest.  Then the tiny
model at K = 120 (one encoder layer; the port with both kernel switches
on, so its kernels' plain versions run, against the flax model on XLA's
attention and FFN, whose Pallas kernels the checks above cover; the MLP
head in place of QNN-alpha, which K does not reach) on converted
parameters: logits and probabilities in fp32 within 1e-4.  One test item
(see ``_torch_helpers``).
"""

import copy

import numpy as np

from _torch_helpers import (
    Checks,
    bf16_band,
    jax_model_and_variables,
    jitted_vjp,
    make_batch,
    run_once,
    port_model,
    tiny_cfg_dict,
    torch_batch,
    torch_threads,
)

P_DROP = 0.2
SEED = 24680
WGRAD_BAND_BF16 = 1e-2
B, D, H = 2, 16, 2


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


def _inputs(seed, K):
    """x, wqkv, bqkv, bias, q, k, v, do; the last 4 key columns masked."""
    rng = np.random.default_rng(seed)
    x, q, k, v, do = (rng.normal(0, 1, (B, K, D)).astype(np.float32) for _ in range(5))
    w = (rng.normal(0, 1, (D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(0, 0.1, 3 * D).astype(np.float32)
    bias = rng.normal(0, 1, (K, K)).astype(np.float32)
    bias[:, K - 4:] = -1e9
    return x, w, b, bias, q, k, v, do


def test_attention_plain_versions_match_pallas_at_large_k():
    import jax
    import jax.numpy as jnp
    import torch

    from tossctr_tpu.ops.pallas_attention import fused_mha as jax_fused_mha
    from tossctr_tpu.ops.pallas_attention import fused_mha_qkv as jax_fused_mha_qkv
    from tossctr_tpu_torch.ops import (
        fused_mha_bwd_reference,
        fused_mha_qkv_bwd_reference,
        fused_mha_qkv_reference,
        fused_mha_reference,
    )

    seed_j = jnp.full((1,), SEED, jnp.int32)

    def np32(t):
        return (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t).astype(np.float32))

    def cast(arrays, dtype, keep_f32=()):
        bf = dtype == "bf16"
        j = [jnp.asarray(a, jnp.bfloat16 if bf and i not in keep_f32 else jnp.float32)
             for i, a in enumerate(arrays)]
        t = [torch.from_numpy(a).to(torch.bfloat16 if bf and i not in keep_f32
                                    else torch.float32) for i, a in enumerate(arrays)]
        return j, t

    def qkv(dtype, p, K):
        x, w, b, bias, _, _, _, do = _inputs(K, K)
        (jargs, targs), (jdo, tdo) = cast((x, w, b, bias), dtype, keep_f32=(2,)), \
            cast((do,), dtype)
        jout, jgrads = jitted_vjp(lambda *a: jax_fused_mha_qkv(*a, seed_j, H, p, 1, True,
                                                                "packed", "hash"), jargs, jdo[0])
        _close("out", dtype, np32(fused_mha_qkv_reference(*targs, H, p, SEED)), np32(jout))
        tgrads = fused_mha_qkv_bwd_reference(*targs, tdo[0], H, p, SEED)
        for i, name in enumerate(("dx", "dwqkv", "dbqkv", "dbias")):
            _close(name, dtype, np32(tgrads[i]), np32(jgrads[i]), activation=i == 0)

    def mha(dtype, p, K):
        _, _, _, bias, q, k, v, do = _inputs(K + 1, K)
        (jargs, targs), (jdo, tdo) = cast((q, k, v, bias), dtype), cast((do,), dtype)
        jout, jgrads = jitted_vjp(lambda *a: jax_fused_mha(*a, seed_j, H, p, 1, True, "packed",
                                                            "hash"), jargs, jdo[0])
        _close("out", dtype, np32(fused_mha_reference(*targs, H, p, SEED)), np32(jout))
        tgrads = fused_mha_bwd_reference(*targs, tdo[0], H, p, SEED)
        for i, name in enumerate(("dq", "dk", "dv", "dbias")):
            _close(name, dtype, np32(tgrads[i]), np32(jgrads[i]), activation=i < 3)

    def model_at_k120():
        d = tiny_cfg_dict(amp="none", **{
            "sequence": {"max_len": 128, "top_k": 120, "tfm": {"n_layers": 1}},
            "model": {"qnn_alpha": {"enabled": False}}})
        batch = make_batch(d, B=2, seed=3)
        # the flax model on XLA's attention and FFN, the port's on its
        # kernels' plain versions: the kernels' own checks are above
        plain = copy.deepcopy(d)
        plain["model"].update(use_pallas_attention=False, use_pallas_ffn=False)
        jmodel, variables = jax_model_and_variables(plain, batch)
        jz, jp, _ = run_once(lambda v, b: jmodel.apply(v, b, deterministic=True),
                             variables, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            z, p, _ = port_model(d, variables)(torch_batch(batch))
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-4)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-4)

    checks = Checks()
    with torch_threads():
        # (K, fused_mha_qkv's setting, fused_mha's setting)
        for K, a, b in ((80, ("f32", 0.0), ("bf16", P_DROP)),
                        (120, ("bf16", P_DROP), ("f32", 0.0)),
                        (152, ("f32", P_DROP), ("bf16", 0.0))):
            checks.run(f"fused_mha_qkv {a[0]} p={a[1]} K={K}", qkv, *a, K)
            checks.run(f"fused_mha {b[0]} p={b[1]} K={K}", mha, *b, K)
        checks.run("tiny model forward at K=120", model_at_k120)
    checks.done()
