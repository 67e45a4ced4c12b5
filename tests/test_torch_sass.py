"""The SASS reader of ``repro_torch.analysis.sass`` on hand-written
``cuobjdump -sass`` text: kernel names, pipe mix, and which loops count
as site loops and how many sites a pass they store."""
import pytest

from repro_torch.analysis import sass

# a k-sweep instance with a tile-load loop (device loads) and a site loop
# of 4-byte stores, then an old-style kernel whose loop stores one byte a
# site and branches to a label, and a loop that only fills a table
TEXT = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121stencil_sweeps_kernelILb0EEEvPKaS2_PKjPa
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   STS [R9], R4 ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   LDS R5, [R9] ;
        /*0050*/                   IMAD.WIDE.U32 R6, R5, -0x326172a9, RZ ;
        /*0060*/                   LOP3.LUT R4, R6, R7, R5, 0x96, !PT ;
        /*0070*/                   STS [R9], R4 ;
        /*0080*/              @!P1 BRA 0x40 ;
        /*0090*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_130stencil_sweeps_resident_kernelEPKaS1_
        /*0000*/                   IMAD.IADD R2, R3, 0x1, R4 ;
        /*0010*/                   STS [R2], R3 ;
        /*0020*/               @P0 BRA 0x0 ;
.L_x_4:
        /*0030*/                   LDS.S8 R5, [R9] ;
        /*0040*/                   I2FP.F32.U32 R6, R5 ;
        /*0050*/                   STS.U8 [R9], R5 ;
        /*0060*/                   STS.U8 [R9+0x1], R5 ;
        /*0070*/               @P1 BRA `(.L_x_4) ;
        /*0080*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_123tensorcore_update_kernelIaLi128EEEvPv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   EXIT ;
"""


def test_names_and_pipe_mix():
    mix = sass.sass_mix(TEXT)
    assert sorted(mix) == ["stencil_sweeps_kernel<false>",
                           "stencil_sweeps_resident_kernel",
                           "tensorcore_update_kernel<a,128>"]
    assert mix["stencil_sweeps_kernel<false>"] == {
        "alu": 1, "fma": 1, "lsu": 4, "other": 4}
    assert mix["tensorcore_update_kernel<a,128>"]["tensor"] == 1


@pytest.mark.parametrize("kernel,want", [
    ("stencil_sweeps_kernel", [("0x40-0x80", 4, 5 / 4)]),
    ("stencil_sweeps_resident", [("0x30-0x70", 2, 5 / 2)]),
    ("tensorcore", []),
])
def test_site_loops_count_sites_by_store_width(kernel, want):
    """Tile loads (device loads) and table fills (no shared loads) are
    not site loops; a 4-byte store is 4 int8 sites, a 1-byte store 1;
    branches to an address and to a label both close a loop."""
    loops = sass.site_loops(TEXT, kernel)
    assert [(lp["range"], lp["sites"], lp["per_site_total"])
            for lp in loops] == want
    if kernel == "stencil_sweeps_kernel":
        assert loops[0]["opcodes_per_site"]["IMAD.WIDE.U32"] == 0.25
        assert loops[0]["per_site"] == {"alu": 0.25, "fma": 0.25,
                                        "lsu": 0.5, "other": 0.25}


def test_template_names_with_two_ints():
    """A kernel template on a type and two ints (the tensor-core kernel's
    plane type and tile) names all three."""
    text = """
\t\tFunction : _ZN12_GLOBAL__N_124tensorcore_update_kernelIaLi64ELi128EEEvPT_
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_124tensorcore_update_kernelItLi16ELi32EEEvPT_
        /*0000*/                   EXIT ;
"""
    assert sorted(sass.sass_mix(text)) == [
        "tensorcore_update_kernel<a,64,128>",
        "tensorcore_update_kernel<t,16,32>"]
