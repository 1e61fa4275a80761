"""QNN-alpha multi-head low-rank FM crosses.

Port of ``tossctr_tpu/ops/fm_cross.py`` and of the FM-cross kernel pair in
``tossctr_tpu/ops/pallas_kernels.py``.  Per head, with A = z @ U_h
(B, F, R): quad = (sum_f A)^2 - sum_f A^2, the pairwise-cross aggregate
without forming F^2 pairs, then quad @ V_h.

* ``fm_cross_multihead`` / ``fm_cross_blocked``: the plain einsum path
  (A in the compute dtype), what the model runs without
  ``model.extra.use_pallas_fm``.
* ``fm_cross_pallas``: the kernel path.  Its kernels are
  ``csrc/fm_cross.cu`` (forward) and ``csrc/fm_cross_bwd.cu`` (backward),
  each in two forms: on the tensor cores for bf16 at the shapes
  ``fm_mma_kernel`` names, on the CUDA cores for fp32 and every other
  shape; ``fm_cross_pallas_reference`` and
  ``fm_cross_pallas_bwd_reference`` are the plain PyTorch versions with
  the Pallas kernels' rounding points (A, its sums and quad in fp32;
  quad rounded to V's dtype before the V product in the forward and not
  in the backward), used for CPU tensors and to check the kernels on the
  card.  ``fm_cross_pallas`` is
  differentiable: its backward is ``fm_cross_pallas_bwd``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ._build import DTYPE_CODES, check_launch, load_library, persistent_blocks, stream_of

MAX_D = 64  # the kernels' limits (csrc/fm_cross.cuh)
MAX_C = 128  # H * R
# the tensor-core kernels' shared memory (csrc/fm_mma.cuh): 8 warps, one
# batch row each, the z ring's stages, and a block's limit on an H100
_MMA_WARPS, _MMA_FWD_STAGES, _MMA_BWD_STAGES = 8, 3, 2
_MMA_SMEM_LIMIT = 232448


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def fm_mma_smem(D: int, H: int, R: int, P: int) -> Tuple[int, int]:
    """Shared memory (bytes) of the forward and the backward tensor-core
    kernels at this shape, as csrc/fm_mma.cuh FwdLayout and BwdLayout lay
    it out (bf16 tiles with rows 8 elements longer than their data)."""
    W, C, DP, CP, PP = _MMA_WARPS, H * R, _r16(D), _r16(H * R), _r16(P)
    ldz, ldc, ldv = DP + 8, CP + 8, PP + 8
    weights = 2 * (DP * ldc + C * ldv)
    fwd = weights + 2 * (_MMA_FWD_STAGES * W * 16 * ldz + W * ldc) + 16
    ring = weights + 2 * 2 * _MMA_BWD_STAGES * W * 16 * ldz  # a stage: two tiles (the sweeps)
    staged = 2 * (W * 16 * (DP + 2 * CP) + DP * CP)  # z, U, dA's halves, canonical, aligned
    bwd = -(-ring // 128) * 128 + staged + 2 * W * (H * PP + 8) + 2 * 4 * W * CP + 16
    return fwd, bwd


def fm_mma_kernel(dtype, D: int, H: int, R: int, P: int) -> bool:
    """Whether fm_cross_pallas's forward and backward of this dtype and
    shape run their tensor-core kernels on the card: bf16, D and R
    multiples of 8 (16-byte pieces of z's rows; whole n8 tiles of each
    head's columns), P a multiple of 4 (8-byte pieces of g's rows), D <=
    64, H*R <= 128, and both kernels' shared memory within a block's.
    Every other shape the kernels take runs the CUDA-core pair."""
    return (dtype == torch.bfloat16 and 8 <= D <= MAX_D and D % 8 == 0 and R % 8 == 0
            and H * R <= MAX_C and P % 4 == 0
            and max(fm_mma_smem(D, H, R, P)) <= _MMA_SMEM_LIMIT)


def fm_cross_multihead(z: torch.Tensor, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """z (B, F, D), U (H, D, R), V (H, R, P) -> (B, H*P)."""
    B = z.shape[0]
    H, _, P = V.shape
    A = torch.einsum("bfd,hdr->bhfr", z, U)
    s = A.sum(dim=2)
    quad = s * s - (A * A).sum(dim=2)
    out = torch.einsum("bhr,hrp->bhp", quad, V)
    return out.reshape(B, H * P)


def fm_cross_blocked(z: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                     block_slices: Dict[str, Tuple[int, int]]) -> torch.Tensor:
    """pair_grouping='block': sum of per-block crosses, skipping
    single-feature blocks."""
    outs = [fm_cross_multihead(z[:, s:e, :], U, V)
            for s, e in block_slices.values() if e - s > 1]
    if not outs:
        return fm_cross_multihead(z, U, V)
    return sum(outs[1:], outs[0])


def _fm_parts(z, U):
    """A (B, H, F, R), s, quad (B, H, R), all fp32 sums of the inputs' values."""
    A = torch.einsum("bfd,hdr->bhfr", z.float(), U.float())
    s = A.sum(dim=2)
    return A, s, s * s - (A * A).sum(dim=2)


def fm_cross_pallas_reference(z, U, V):
    """The kernel's function in plain PyTorch (pallas_kernels.py:51-73,
    140-160): fp32 A, s and quad; quad rounded to V's dtype; the V product
    summed in fp32 and the output rounded to z's dtype once -> (B, H*P)."""
    B = z.shape[0]
    H, _, P = V.shape
    _, _, quad = _fm_parts(z, U)
    out = torch.einsum("bhr,hrp->bhp", quad.to(V.dtype).float(), V.float())
    return out.reshape(B, H * P).to(z.dtype)


def fm_cross_pallas_bwd_reference(z, U, V, g):
    """Gradients of ``fm_cross_pallas_reference`` w.r.t. z, U and V for the
    output gradient ``g`` (B, H*P), with the Pallas backward's rounding
    points (pallas_kernels.py:76-137): A recomputed in fp32, dV from the
    unrounded quad, dquad = g V^T, dA = 2 dquad (s - A), dz summed over the
    heads in fp32 and rounded to z's dtype once.  -> (dz, dU (H, D, R),
    dV (H, R, P)), the last two fp32 sums over the batch."""
    B, F, D = z.shape
    H, R, P = V.shape
    A, s, quad = _fm_parts(z, U)
    gh = g.float().reshape(B, H, P)
    dV = torch.einsum("bhr,bhp->hrp", quad, gh)
    dquad = torch.einsum("bhp,hrp->bhr", gh, V.float())
    dA = (2.0 * dquad)[:, :, None, :] * (s[:, :, None, :] - A)
    dz = torch.einsum("bhfr,hdr->bfd", dA, U.float())
    dU = torch.einsum("bfd,bhfr->hdr", z.float(), dA)
    return dz.to(z.dtype), dU, dV


def _check(z, U, V):
    if z.dim() != 3 or U.dim() != 3 or V.dim() != 3:
        raise ValueError(f"z (B, F, D), U (H, D, R), V (H, R, P) expected, got "
                         f"{tuple(z.shape)}, {tuple(U.shape)}, {tuple(V.shape)}")
    B, F, D = z.shape
    H, D_u, R = U.shape
    if D_u != D or V.shape[0] != H or V.shape[1] != R:
        raise ValueError(f"shapes disagree: z {tuple(z.shape)}, U {tuple(U.shape)}, "
                         f"V {tuple(V.shape)}")
    if z.dtype not in DTYPE_CODES:
        raise TypeError(f"z dtype must be float32 or bfloat16, got {z.dtype}")
    for name, t in (("U", U), ("V", V)):
        if t.dtype != z.dtype or t.device != z.device:
            raise ValueError(f"{name} must be {z.dtype} on {z.device}, got {t.dtype} on {t.device}")


def _cuda_args(name, tensors):
    if tensors[0].device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    B, _, D = tensors[0].shape
    H, _, R = tensors[1].shape
    if B < 1 or D > MAX_D or H * R > MAX_C:
        raise ValueError(f"{name} kernel takes B >= 1, D <= {MAX_D} and H*R <= {MAX_C}; "
                         f"got B={B} D={D} H*R={H * R}")


def launch_fwd(fn, z, U, V, blocks=None):
    """-> (rc, out): one call of the forward's C entry point ``fn`` (the
    built library's, or a probe's variant of it) on checked CUDA tensors."""
    B, F, D = z.shape
    H, R, P = V.shape
    out = torch.empty(B, H * P, dtype=z.dtype, device=z.device)
    rc = fn(z.data_ptr(), U.data_ptr(), V.data_ptr(), out.data_ptr(), B, F, D, H, R, P,
            int(blocks or 0), int(fm_mma_kernel(z.dtype, D, H, R, P)), DTYPE_CODES[z.dtype],
            z.device.index, stream_of(z))
    return rc, out


def launch_bwd(fn, z, U, V, g, blocks=None):
    """-> (rc, (dz, dU, dV)): one call of the backward's C entry point
    ``fn`` on checked CUDA tensors, its scratch and outputs allocated."""
    B, F, D = z.shape
    H, R, P = V.shape
    blocks = persistent_blocks(z, blocks=blocks)
    chunks = min(B, 64)
    n_u, n_v = H * D * R, H * R * P
    f32 = dict(dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    scratch = torch.empty(B * H * R + blocks * n_u + chunks * n_v, **f32)
    quad, part_u, part_v = scratch.split([B * H * R, blocks * n_u, chunks * n_v])
    grads = torch.empty(n_u + n_v, **f32)
    rc = fn(z.data_ptr(), U.data_ptr(), V.data_ptr(), g.data_ptr(), dz.data_ptr(),
            quad.data_ptr(), part_u.data_ptr(), part_v.data_ptr(), grads.data_ptr(), blocks,
            chunks, B, F, D, H, R, P, int(fm_mma_kernel(z.dtype, D, H, R, P)),
            DTYPE_CODES[z.dtype], z.device.index, stream_of(z))
    dU, dV = grads.split([n_u, n_v])
    return rc, (dz, dU.view(H, D, R), dV.view(H, R, P))


def fm_cross_pallas_fwd(z, U, V, blocks=None):
    """The forward alone (no autograd): the kernel on a CUDA tensor (the
    tensor-core one where ``fm_mma_kernel`` says so), the plain version on
    a CPU tensor.  ``blocks`` caps the kernel's persistent grid (default:
    as many blocks as fit on the SMs); the output does not depend on it."""
    _check(z, U, V)
    if z.device.type == "cpu":
        return fm_cross_pallas_reference(z, U, V)
    _cuda_args("fm_cross_pallas", (z, U, V))
    lib = load_library("fm_cross")
    rc, out = launch_fwd(lib.tossctr_fm_cross_fwd, z, U, V, blocks)
    check_launch(lib, rc, "fm_cross_pallas")
    fm_cross_pallas.launches += 1
    return out


def fm_cross_pallas_bwd(z, U, V, g, blocks=None):
    """-> (dz, dU, dV), the last two fp32 sums over the batch: the kernel
    on a CUDA tensor (the tensor-core one where ``fm_mma_kernel`` says so;
    per-block and per-chunk fp32 partials reduced in a fixed order, so the
    result repeats bit for bit), the plain version on a CPU tensor.
    ``blocks``: the persistent grid (default one block an SM); dz and dV
    do not depend on it, dU's partials regroup."""
    _check(z, U, V)
    B = z.shape[0]
    H, R, P = V.shape
    if tuple(g.shape) != (B, H * P) or g.dtype != z.dtype or g.device != z.device:
        raise ValueError(f"g must be ({B}, {H * P}) {z.dtype} on {z.device}, got "
                         f"{tuple(g.shape)} {g.dtype} {g.device}")
    if z.device.type == "cpu":
        return fm_cross_pallas_bwd_reference(z, U, V, g)
    _cuda_args("fm_cross_pallas_bwd", (z, U, V, g))
    lib = load_library("fm_cross_bwd")
    rc, grads = launch_bwd(lib.tossctr_fm_cross_bwd, z, U, V, g, blocks)
    check_launch(lib, rc, "fm_cross_pallas_bwd")
    fm_cross_pallas_bwd.launches += 1
    return grads


class _FMCross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, U, V):
        ctx.save_for_backward(z, U, V)
        return fm_cross_pallas_fwd(z, U, V)

    @staticmethod
    def backward(ctx, g):
        z, U, V = ctx.saved_tensors
        dz, dU, dV = fm_cross_pallas_bwd(z, U, V, g.contiguous())
        # dU, dV leave in the dtypes of U and V, as the Pallas custom_vjp
        # returns them (pallas_kernels.py:215)
        return dz, dU.to(U.dtype), dV.to(V.dtype)


def fm_cross_pallas(z, U, V):
    """Fused multi-head FM cross: z (B, F, D), U (H, D, R), V (H, R, P) of
    one dtype -> (B, H*P) in that dtype.  Differentiable in z, U and V.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    or raise."""
    return _FMCross.apply(z, U, V)


fm_cross_pallas.launches = 0
fm_cross_pallas_bwd.launches = 0
