"""The measurement helpers of the port's kernels (heat_tpu_torch/core/kernels/_measure.py),
which chip_smoke.py and tools/ use on the card: the ptxas and SASS parsers on listings
written out here, the refusal to report SASS that could not be read, and the flash
forward's tolerance. None of them needs a card."""

import numpy as np
import pytest
import torch

from heat_tpu_torch.core.kernels import _measure

SASS = """
        Function : kernel_a
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/              @!PT LDS RZ, [RZ] ;
        /*0020*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0030*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;
        /*0040*/                   FFMA R2, R3, R5, R2 ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
"""

PTXAS = """ptxas info    : Compiling entry function 'kernel_a' for 'sm_90a'
ptxas info    : Function properties for kernel_a
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, 380 bytes cmem[0]
ptxas info    : Compiling entry function 'kernel_b' for 'sm_90a'
ptxas info    : Function properties for kernel_b
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""


def test_sass_counts_instructions_hmma_and_the_largest_loop():
    lines = SASS.splitlines()[3:]
    got = _measure.sass_counts(lines)
    assert got["instructions"] == 8
    assert got["hmma"] == 2
    assert got["opcodes"] == {"BRA": 2, "HMMA": 2, "LDC": 1, "LDS": 1, "FFMA": 1, "EXIT": 1}
    # the loop from 0x20 back to the branch at 0x50, not the one-instruction loop at 0x70
    assert got["loop"] == {"instructions": 4, "hmma": 2, "opcodes": {"HMMA": 2, "FFMA": 1, "BRA": 1}}


def test_sass_counts_of_a_listing_without_a_loop():
    got = _measure.sass_counts(SASS.splitlines()[3:6])
    assert got == {"instructions": 2, "hmma": 0, "opcodes": {"LDC": 1, "LDS": 1}, "loop": {}}


def test_ptxas_summary_reads_registers_and_spills():
    assert _measure.ptxas_summary(PTXAS) == [["kernel_a", 128, 4, 12], ["kernel_b", 40, 0, 0]]


def test_sass_raises_where_it_cannot_read_a_library(tmp_path):
    # no toolkit here, or cuobjdump failing on a file that is not a library: never an empty result
    with pytest.raises(RuntimeError):
        _measure.sass(tmp_path / "missing.so")


@pytest.mark.parametrize("dtype, rel", [(torch.float32, 2e-4), (torch.bfloat16, 2.0**-7)])
def test_fwd_err_holds_o_to_its_type_and_lse_to_2e4(dtype, rel):
    rng = np.random.default_rng(0)
    ro = torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32)).to(dtype)
    rl = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    assert _measure.fwd_err(ro, rl, ro, rl) == (0.0, 0.0, 0.0)
    one = torch.ones(2, 8, 4, dtype=dtype)
    # one step of the type's tolerance on O of magnitude 1 (1 + 2⁻⁷ is exact in bf16)
    assert _measure.fwd_err((one.float() + rel).to(dtype), rl, one, rl)[2] == pytest.approx(rel / (2e-4 + rel), rel=1e-3)
    lse = rl + 2.0 * (2e-4 + 2e-4 * rl.abs())
    assert _measure.fwd_err(ro, lse, ro, rl)[2] == pytest.approx(2.0, rel=1e-3)
