"""The port's CTRModel against the flax CTRModel on converted parameters.

The flax model is the JAX package's own ``build_model`` with the fused
attention and block-tail kernels on (interpret mode on CPU) and fused
sequence tables; its initialised parameters go through
``convert.flax_to_state_dict`` into the port, and both run the same
numpy batch with dropout off.

* fp32: logits, probabilities and the aux logit agree to 1e-4.
* bf16 (``amp: bf16``, bf16 table): probabilities agree within 0.02.
  XLA and torch round bf16 products and sums at other points, so a
  logit moves by a few bf16 ulps; and a near-tie between two selection
  scores can resolve the other way, swapping one selected token.  The
  band bounds the end result, not each intermediate.

The unfused encoder (``use_pallas_attention`` / ``use_pallas_ffn``
false) is held in fp32 too.  Configs that ask for a path the port has
not ported (split tables, streaming selection) raise.  One test item
(see ``_torch_helpers``).
"""

import numpy as np
import pytest

import _torch_helpers as H


def _compare(d, seeds=(1, 2), B=8):
    import jax
    import torch

    batch0 = H.make_batch(d, B=B, seed=seeds[0])
    model, variables = H.jax_model_and_variables(d, batch0)
    apply = H.compiled(jax.jit(lambda v, b: model.apply(v, b, deterministic=True)), variables,
                       batch0)
    port = H.port_model(d, variables)
    worst = {"z": 0.0, "p": 0.0, "aux": 0.0}
    for s in seeds:
        batch = H.make_batch(d, B=B, seed=s)
        want = [np.asarray(a, np.float32) for a in apply(variables, batch)]
        with torch.inference_mode():
            got = [t.float().numpy() for t in port(H.torch_batch(batch))]
        for name, w, g in zip(("z", "p", "aux"), want, got):
            assert g.shape == w.shape and g.dtype == np.float32
            worst[name] = max(worst[name], float(np.abs(w - g).max()))
    return worst


def test_model_matches_flax():
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.models import build_model

    def fp32(d):
        worst = _compare(d)
        assert max(worst.values()) < 1e-4, worst

    def bf16_band(d):
        worst = _compare(d, seeds=(1, 2, 3))
        assert worst["p"] < 0.02, worst

    def unported_path_raises(over):
        d = H.tiny_cfg_dict("none", **over)
        with pytest.raises(NotImplementedError):
            build_model(Config.from_dict(d), H.dims_for(d), device="cpu")

    checks = H.Checks()
    with H.torch_threads():
        checks.run("flagship shape fp32", fp32, H.tiny_cfg_dict("none"))
        checks.run("flagship shape bf16", bf16_band, H.tiny_cfg_dict("bf16"))
        checks.run("S1 query, block pairs, relu gating, no SE, fp32", fp32, H.tiny_cfg_dict(
            "none",
            sequence={"query_mode": "S1", "top_k": 8, "tfm": {"gating": "relu", "n_heads": 4}},
            model={"qnn_alpha": {"pair_grouping": "block", "use_se": False}},
        ))
        checks.run("S2 query, MLP head, no transformer, fp32", fp32, H.tiny_cfg_dict(
            "none",
            sequence={"query_mode": "S2", "transformer_block": False},
            model={"qnn_alpha": {"enabled": False}},
        ))
        checks.run("unfused encoder fp32", fp32, H.tiny_cfg_dict(
            "none", model={"use_pallas_attention": False, "use_pallas_ffn": False}))
        for over in (
            {"model": {"fused_seq_tables": False}},
            {"sequence": {"select_chunk": 8}},
        ):
            checks.run(f"unported {over} raises", unported_path_raises, over)
    checks.done()
