"""The bf16 attention kernels' warp-unit forms (both forwards, both
backwards), what the CPU can check of them (the kernels themselves run
only on the card, in test_torch_cuda_kernels.py):

* the softmax's division (``csrc/mha_mma.cuh`` ``div_rn``): one
  reciprocal a row rounded to nearest, then RN(e r) corrected once with
  its exact residual, must be the correctly rounded quotient e / l, as
  the CUDA-core kernels' ``__fdiv_rn`` is.  Held in exact rational
  arithmetic on 4,000 float32 pairs drawn as the softmax draws them (e =
  exp(s - max) in (0, 1], l their row sum in [1, 152]) and on the edges
  (e = l, e = 0, powers of two);
* the wrappers' shape rules match the C sources' constants: the
  backwards' K <= 160 (``kMaxKP``), with dbias in registers and no other
  bf16 kernel up to K = 128 (``kMaxKPRegs``) and above it the heads
  padded to at most 64 columns (``bwd_unit_shape``), the forwards' K <=
  160 (``kMaxKPFwd``) with the heads padded to at most 64 columns
  (``kMaxFwdNQ``), head widths 4 to 16 in steps of 4 (``head_ok``), the
  qkv backward's dWqkv in at most 48 units of 16 x 16 (``kWUnits``), and
  the head-padded widths the rules imply at the shapes the card tests
  run; the forwards' C entry points refuse, for the warp-unit kernel,
  the shapes the wrapper's rule sends to the tiled one; the backwards'
  C entry points run the tensor-core kernel for the shapes
  ``bwd_mma_kernel`` names, refuse the others at K <= 128 and send them
  to the key-tiled kernel above.

One test item (see ``_torch_helpers``).
"""

import pathlib
import re
from fractions import Fraction

import numpy as np

from _torch_helpers import Checks

CSRC = pathlib.Path(__file__).resolve().parents[1] / "tossctr_tpu_torch" / "csrc"


def rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even), exactly; normal
    range only (what the softmax's quotients are)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    m, rem = divmod(scaled.numerator, scaled.denominator)
    half = Fraction(rem, scaled.denominator)
    if half > Fraction(1, 2) or (half == Fraction(1, 2) and m % 2):
        m += 1
    return sign * m * Fraction(2) ** (e - 23)


def div_rn(e: Fraction, l: Fraction) -> Fraction:
    """The kernel's division, each operation rounded as the card rounds it:
    r = __frcp_rn(l), q = __fmul_rn(e, r), the residual by one FMA, and the
    correction by another."""
    r = rn32(1 / l)
    q = rn32(e * r)
    return rn32(rn32(e - l * q) * r + q)


def test_attention_mma_division_and_shape_rules():
    import torch

    fa = __import__("tossctr_tpu_torch.ops.fused_attention", fromlist=["x"])

    def division_is_correctly_rounded():
        rng = np.random.default_rng(0)
        s = rng.uniform(-30.0, 0.0, 4000).astype(np.float32)
        es = np.exp(s).astype(np.float32)
        ls = rng.uniform(1.0, 152.0, 4000).astype(np.float32)
        ls = np.maximum(ls, es)
        pairs = [(Fraction(float(e)), Fraction(float(l))) for e, l in zip(es, ls)]
        for l in (1.0, 2.0, 3.0, 64.0, 60.0, 152.0, 1.0000001):
            lf = Fraction(float(np.float32(l)))
            pairs += [(lf, lf), (Fraction(0), lf), (Fraction(1), lf), (Fraction(1, 2), lf)]
        bad = [(float(e), float(l)) for e, l in pairs if div_rn(e, l) != rn32(e / l)]
        assert not bad, f"{len(bad)} of {len(pairs)} quotients not correctly rounded: {bad[:5]}"

    def shape_rules_match_the_sources():
        core = (CSRC / "mha_mma.cuh").read_text()
        qkv = (CSRC / "fused_mha_qkv_bwd.cu").read_text()
        mha = (CSRC / "fused_mha_bwd.cu").read_text()
        assert re.search(r"constexpr int kMaxKP = (\d+);", core).group(1) == str(fa.MMA_MAX_K)
        assert re.search(r"constexpr int kMaxKPRegs = (\d+);", core).group(1) == str(
            fa.MMA_REGS_MAX_K)
        assert ("return g.K <= kMaxKP && head_ok(g.dh) && (g.K <= kMaxKPRegs || "
                "g.H * g.DHP <= kMaxFwdNQ);" in core)
        for src in (qkv, mha):
            assert "if (!tossctr::mha_mma::bwd_unit_shape(" in src
        assert "if (dtype == 1 && K <= tc::kMaxKPRegs) return (int)cudaErrorInvalidValue;" in qkv
        assert "if (K <= tc::kMaxKPRegs) return (int)cudaErrorInvalidValue;" in mha
        assert "return dh >= 4 && dh <= 16 && dh % 4 == 0;" in core
        assert re.search(r"constexpr int kWUnits = (\d+);", qkv).group(1) == str(
            fa._MMA_WGRAD_UNITS)
        assert re.search(r"constexpr int kMaxKPFwd = (\d+);", core).group(1) == str(
            fa.MMA_FWD_MAX_K)
        assert re.search(r"constexpr int kMaxFwdNQ = (\d+);", core).group(1) == str(
            fa._MMA_FWD_MAX_NQ)
        takes = [dh for dh in range(1, 65) if fa._mma_head_ok(dh)]
        assert takes == [4, 8, 12, 16], takes
        assert ("return g.K <= kMaxKPFwd && head_ok(g.dh) && g.H * g.DHP <= kMaxFwdNQ;"
                in core)
        for name in ("fused_mha.cu", "fused_mha_qkv.cu"):
            src = (CSRC / name).read_text()
            assert "!tossctr::mha_mma::fwd_unit_shape(tossctr::mha_mma::Geo(K, D, H))" in src, name
        # (dtype, K, D, H) -> the forwards run their warp-unit kernels: bf16,
        # K <= 160, dh 4-16, the heads padded to at most 64 columns
        bf, f32 = torch.bfloat16, torch.float32
        for (dt, K, D, H), ok in {(bf, 64, 64, 8): True, (bf, 120, 64, 8): True,
                                  (bf, 152, 64, 8): True, (bf, 160, 64, 4): True,
                                  (bf, 13, 32, 8): True, (bf, 77, 48, 4): True,
                                  (bf, 80, 32, 2): True, (bf, 161, 64, 8): False,
                                  (bf, 64, 64, 16): False, (bf, 64, 64, 2): False,
                                  (bf, 64, 96, 8): False, (bf, 64, 24, 4): False,
                                  (f32, 64, 64, 8): False}.items():
            assert fa.fwd_unit_kernel(dt, K, D, H) is ok, (dt, K, D, H)
        # (D, H) -> the qkv kernel takes it: its dWqkv (round_up(D, 16), 3 NQ)
        # with NQ = round_up(H * (8 or 16), 16) in at most 48 units of 16 x 16
        for (D, H), ok in {(64, 8): True, (16, 4): True, (64, 4): True, (48, 4): True,
                           (32, 2): True, (32, 8): True, (64, 16): False, (24, 4): False,
                           (64, 2): False, (56, 14): False}.items():
            assert fa._mma_qkv_ok(D, H) is ok, (D, H)
        # (dtype, K, D, H) -> (qkv, mha) backwards on their tensor-core
        # kernels: bf16, K <= 160, dh 4-16 (and the qkv kernel's dWqkv
        # units); above K = 128 also the heads padded to at most 64 columns
        for (dt, K, D, H), ok in {(bf, 64, 64, 8): (True, True), (bf, 120, 64, 8): (True, True),
                                  (bf, 128, 64, 16): (False, True),
                                  (bf, 129, 64, 8): (True, True), (bf, 152, 64, 8): (True, True),
                                  (bf, 137, 48, 4): (True, True), (bf, 160, 32, 8): (True, True),
                                  (bf, 160, 64, 4): (True, True), (bf, 160, 48, 6): (True, True),
                                  (bf, 152, 64, 16): (False, False),
                                  (bf, 152, 48, 12): (False, False),
                                  (bf, 152, 64, 2): (False, False),
                                  (bf, 161, 64, 8): (False, False),
                                  (f32, 152, 64, 8): (False, False)}.items():
            got = tuple(fa.bwd_mma_kernel(dt, K, D, H, qkv) for qkv in (True, False))
            assert got == ok, (dt, K, D, H, got)

    checks = Checks()
    checks.run("division is correctly rounded", division_is_correctly_rounded)
    checks.run("shape rules match the sources", shape_rules_match_the_sources)
    checks.done()
