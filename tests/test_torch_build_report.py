"""The kernel build's reports: ptxas's register, shared-memory and spill
lines and the tensor-core instruction counts read from ``cuobjdump
-sass``, parsed from fixed texts in the tools' formats (no card and no
CUDA toolkit needed).  ``chip_smoke.py`` prints both for the ``fused_ffn``
kernels and fails on a bf16 tensor-core kernel without HMMA / HGMMA."""

from tossctr_tpu_torch.ops._build import parse_ptxas, parse_sass_counts

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12tc11ffn_fwd_mmaILi64EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_12tc11ffn_fwd_mmaILi64EEEvPK13__nv_bfloat16
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114ffn_fwd_kernelIfEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114ffn_fwd_kernelIfEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem, 400 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_12tc11ffn_fwd_mmaILi64EEEvPK13__nv_bfloat16
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0a10*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0a20*/                   HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
        /*0a30*/                   LDSM.16.MT88.4 R8, [R2] ;
\t\tFunction : _ZN12_GLOBAL__N_114ffn_fwd_kernelIfEEvPKT_
        /*0a20*/                   FFMA R1, R2, R3, R4 ;
        /*0b20*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""


def test_ptxas_and_sass_reports_parse():
    rep = parse_ptxas(PTXAS)
    mma = "_ZN12_GLOBAL__N_12tc11ffn_fwd_mmaILi64EEEvPK13__nv_bfloat16"
    fp32 = "_ZN12_GLOBAL__N_114ffn_fwd_kernelIfEEvPKT_"
    assert rep == {
        mma: dict(registers=128, smem=0, spill_stores=8, spill_loads=12),
        fp32: dict(registers=40, smem=1024, spill_stores=0, spill_loads=0),
    }
    counts = parse_sass_counts(SASS)
    assert counts == {mma: {"HMMA": 2, "HGMMA": 0}, fp32: {"HMMA": 0, "HGMMA": 1}}
    assert parse_ptxas("") == {} and parse_sass_counts("") == {}
