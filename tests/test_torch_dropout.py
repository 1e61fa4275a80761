"""The port's counter-hash dropout masks (``tossctr_tpu_torch.ops.dropout``)
bit for bit against the JAX package's numpy oracles
``pallas_attention.dropout_keep_reference`` and
``pallas_ffn.ffn_keep_reference``: the same keep pattern and the same
fp32 keep scale, over several rates and seeds (the full int32 range of
``layers.dropout_seed``), row offsets and ragged shapes.  The CUDA
kernels compute the same hash (``csrc/common.cuh``); the card tests hold
them to the plain versions that use these masks.  One test item (see
``_torch_helpers``).
"""

import numpy as np

from _torch_helpers import Checks, torch_threads


def test_dropout_masks_match_the_jax_oracles():
    from tossctr_tpu.ops.pallas_attention import dropout_keep_reference as jax_attn_oracle
    from tossctr_tpu.ops.pallas_ffn import ffn_keep_reference as jax_ffn_oracle
    from tossctr_tpu_torch.ops import dropout as pd

    def attention_mask(B, K, H, p, seed):
        want = jax_attn_oracle(B, K, K, H, p, seed)  # (H, B, K, K)
        got = pd.attention_keep(B, K, H, p, seed).numpy().transpose(1, 0, 2, 3)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pd.dropout_keep_reference(B, K, K, H, p, seed), want)
        # a block of rows starting at row0 is the same rows of the whole mask
        part = pd.attention_keep(B - 2, K, H, p, seed, row0=2).numpy().transpose(1, 0, 2, 3)
        np.testing.assert_array_equal(part, want[:, 2:])
        kept = want != 0
        assert 0 < kept.mean() < 1
        assert set(np.unique(want)) == {np.float32(0), np.float32(pd.keep_scale(p))}

    def ffn_mask(N, F, p, seed):
        want = jax_ffn_oracle(N, F, p, seed)
        got = pd.ffn_keep(N, F, p, seed).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pd.ffn_keep_reference(N, F, p, seed), want)
        np.testing.assert_array_equal(pd.ffn_keep(N - 5, F, p, seed, row0=5).numpy(), want[5:])

    def keep_rate_is_one_minus_p():
        keep = pd.ffn_keep(4096, 384, 0.1, 7).numpy() != 0
        assert abs(keep.mean() - 0.9) < 0.005, keep.mean()

    checks = Checks()
    with torch_threads():
        for p in (0.1, 0.2, 0.5):
            for seed in (0, 12345, 2**31 - 2):
                checks.run(f"attention p={p} seed={seed}", attention_mask, 5, 13, 4, p, seed)
                checks.run(f"ffn p={p} seed={seed}", ffn_mask, 37, 40, p, seed)
        checks.run("attention flagship head count", attention_mask, 3, 64, 8, 0.1, 99)
        checks.run("keep rate", keep_rate_is_one_minus_p)
    checks.done()
