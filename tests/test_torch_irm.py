"""The port's copy of the paper's model (``repro_torch.core``) against
``repro.core`` on the paper's Tables 1-2 and its three GPUs, equal to
1e-12 relative (the same formulas on the same numbers); the H100 spec's
Eq. 3 arithmetic with the card's readings injected; the SASS census on a
listing written here; and the H100 roofline's arithmetic from a census
and BabelStream times made up here.  The census and the roofline on the
card's own kernels run in ``chip_smoke.py``.
"""
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.core import hardware as jhw
from repro.core import irm as jirm
from repro.core import paper_data as jdata
from repro.core import report as jreport
from repro_torch.core import hardware, irm, paper_data, paper_model, report
from repro_torch.core import sass_counters as sc
from repro_torch.kernels.stream import stream
from repro_torch.launch import babelstream
from repro_torch.launch import irm as launch_irm

REPO = Path(__file__).resolve().parents[1]
REL = 1e-12
GPUS = ("v100", "mi60", "mi100")
CASES = [(t, g) for t in ("TABLE1", "TABLE2") for g in GPUS]


def close(a, b) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


@pytest.mark.parametrize("gpu", GPUS)
def test_hardware_matches_reference(gpu):
    mine, theirs = hardware.get(gpu), jhw.get(gpu)
    for f in ("name", "vendor", "compute_units", "schedulers_per_cu", "ipc",
              "frequency_ghz", "lanes_per_issue", "hbm_bw_theoretical_gbs",
              "hbm_bw_measured_gbs", "hbm_gib"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert close(mine.peak_gips(), theirs.peak_gips())
    assert close(mine.memory_ceiling_gbs(), theirs.memory_ceiling_gbs())


@pytest.mark.parametrize("table,gpu", CASES)
def test_paper_model_matches_reference(table, gpu):
    """Eqs. 2-4 and the bound on the paper's raw counters."""
    mine = getattr(paper_data, table)[gpu]
    theirs = getattr(jdata, table)[gpu]
    assert (mine.name, mine.runtime_s, mine.instructions, mine.bytes_read,
            mine.bytes_written) == (theirs.name, theirs.runtime_s,
                                    theirs.instructions, theirs.bytes_read,
                                    theirs.bytes_written)
    for fn in ("peak_gips", "achieved_gips", "intensity",
               "intensity_performance", "memory_bound_gips"):
        assert close(getattr(mine, fn)(), getattr(theirs, fn)()), fn
    assert close(mine.scaled_instructions, theirs.scaled_instructions)
    assert mine.bound() == theirs.bound()


def test_published_values_match_reference():
    assert paper_data.LWFA_PUBLISHED == jdata.LWFA_PUBLISHED
    assert paper_data.TWEAC_PUBLISHED == jdata.TWEAC_PUBLISHED
    assert paper_data.V100_LWFA_INTENSITY_PER_TXN == \
        jdata.V100_LWFA_INTENSITY_PER_TXN
    assert paper_data.V100_TWEAC_INTENSITY_PER_TXN == \
        jdata.V100_TWEAC_INTENSITY_PER_TXN


@pytest.mark.parametrize("table,gpu", CASES)
def test_gpu_irm_matches_reference(table, gpu):
    """Ceilings, knee, points, roof, headroom and classification."""
    mine = irm.gpu_irm(hardware.get(gpu), [getattr(paper_data, table)[gpu]])
    theirs = jirm.gpu_irm(jhw.get(gpu), [getattr(jdata, table)[gpu]])
    assert [(c.label, c.gips, c.gbs) for c in mine.ceilings] == \
        [(c.label, c.gips, c.gbs) for c in theirs.ceilings]
    assert close(mine.knee(), theirs.knee())
    for p, q in zip(mine.points, theirs.points):
        assert close(p.intensity, q.intensity) and close(p.gips, q.gips)
        assert close(mine.roof_at(p.intensity), theirs.roof_at(q.intensity))
        assert close(mine.headroom(p), theirs.headroom(q))
        assert mine.classify(p) == theirs.classify(q)


def test_equation_helpers_match_reference():
    from repro.core import paper_model as jmodel
    assert paper_model.amd_instructions(10.0, 3.0) == \
        jmodel.amd_instructions(10.0, 3.0) == 43.0
    assert close(paper_model.instruction_intensity_per_transaction(
        640.0, 4.0, 32), jmodel.instruction_intensity_per_transaction(
        640.0, 4.0, 32))
    with pytest.raises(ValueError):
        paper_model.achieved_gips(1.0, 0.0, 32)


def test_report_matches_reference(tmp_path):
    rows = [{"kernel": "copy", "ms": 0.0891, "gips": 117.6, "n": 3,
             "tiny": 1e-7, "big": 2.5e12}]
    assert report.markdown_table(rows) == jreport.markdown_table(rows)
    assert report.csv_lines(rows, ["kernel", "gips"]) == \
        jreport.csv_lines(rows, ["kernel", "gips"])
    assert report.markdown_table([]) == "(no rows)"
    report.dump_json({"rows": rows, "path": tmp_path}, str(tmp_path / "a"))
    jreport.dump_json({"rows": rows, "path": tmp_path}, str(tmp_path / "b"))
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()


def test_h100_spec_eq3():
    """132 SMs x 4 schedulers x IPC 1 x 1.98 GHz = 1045.44 GIPS; the
    measured ceiling replaces the data sheet's 3352 GB/s when given."""
    spec = hardware.h100_spec("NVIDIA H100 80GB HBM3", 132, 1980.0,
                              80 * 2 ** 30)
    assert close(spec.peak_gips(), 1045.44)
    assert spec.memory_ceiling_gbs() == 3352.0
    assert (spec.lanes_per_issue, spec.hbm_gib) == (32, 80.0)
    measured = hardware.h100_spec("h", 132, 1980.0, 0, measured_gbs=3000.5)
    assert measured.memory_ceiling_gbs() == 3000.5
    assert close(measured.peak_gips(), 132 * 4 * 1 * 1.98)


def test_h100_from_device_reads_the_card(monkeypatch):
    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                                  multi_processor_count=114,
                                  total_memory=85 * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props)
    monkeypatch.setattr(hardware, "max_sm_clock_mhz", lambda: 1755.0)
    spec = hardware.h100_from_device(measured_gbs=1900.0)
    assert (spec.name, spec.compute_units) == (props.name, 114)
    assert close(spec.peak_gips(), 114 * 4 * 1.755)
    assert spec.memory_ceiling_gbs() == 1900.0
    assert close(spec.hbm_gib, 85e9 / 2 ** 30)


def test_h100_from_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        hardware.h100_from_device()


# A cuobjdump -sass listing for sm_90a: the port's first f32 copy kernel
# (one element a thread) as nvcc 12.8 compiled it (bounds guard as a
# predicated EXIT; padding cut
# to four NOPs), then, written for the test, a loop-free block sum with
# shuffles, shared memory, a barrier and a forward branch, and a kernel
# with a loop (a backward branch).  Each function ends in the self-branch
# and NOPs that pad it.
LISTING = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : stream_copy_f32
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_ACCELERATORS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                             /* 0x00000a00ff017b82 */
                                                                                      /* 0x000e220000000800 */
        /*0010*/                   S2R R5, SR_CTAID.X ;                               /* 0x0000000000057919 */
                                                                                      /* 0x000e620000002500 */
        /*0020*/                   IMAD.MOV.U32 R3, RZ, RZ, RZ ;                      /* 0x000000ffff037224 */
                                                                                      /* 0x000fe200078e00ff */
        /*0030*/                   ULDC.64 UR4, c[0x0][0x220] ;                       /* 0x0000880000047ab9 */
                                                                                      /* 0x000fe20000000a00 */
        /*0040*/                   S2R R2, SR_TID.X ;                                 /* 0x0000000000027919 */
                                                                                      /* 0x000e640000002100 */
        /*0050*/                   IMAD.WIDE.U32 R2, R5, 0x400, R2 ;                  /* 0x0000040005027825 */
                                                                                      /* 0x002fc600078e0002 */
        /*0060*/                   ISETP.GE.U32.AND P0, PT, R2, UR4, PT ;             /* 0x0000000402007c0c */
                                                                                      /* 0x000fc8000bf06070 */
        /*0070*/                   ISETP.GE.AND.EX P0, PT, R3, UR5, PT, P0 ;          /* 0x0000000503007c0c */
                                                                                      /* 0x000fda000bf06300 */
        /*0080*/               @P0 EXIT ;                                             /* 0x000000000000094d */
                                                                                      /* 0x001fea0003800000 */
        /*0090*/                   IMAD.SHL.U32 R4, R2.reuse, 0x4, RZ ;               /* 0x0000000402047824 */
                                                                                      /* 0x040fe200078e00ff */
        /*00a0*/                   ULDC.64 UR4, c[0x0][0x210] ;                       /* 0x0000840000047ab9 */
                                                                                      /* 0x000fe20000000a00 */
        /*00b0*/                   SHF.L.U64.HI R0, R2, 0x2, R3 ;                     /* 0x0000000202007819 */
                                                                                      /* 0x000fe20000010203 */
        /*00c0*/                   ULDC.64 UR6, c[0x0][0x218] ;                       /* 0x0000860000067ab9 */
                                                                                      /* 0x000fe40000000a00 */
        /*00d0*/                   IADD3 R2, P0, R4, UR4, RZ ;                        /* 0x0000000404027c10 */
                                                                                      /* 0x000fc8000ff1e0ff */
        /*00e0*/                   IADD3.X R3, R0, UR5, RZ, P0, !PT ;                 /* 0x0000000500037c10 */
                                                                                      /* 0x000fe200087fe4ff */
        /*00f0*/                   ULDC.64 UR4, c[0x0][0x208] ;                       /* 0x0000820000047ab9 */
                                                                                      /* 0x000fca0000000a00 */
        /*0100*/                   LDG.E R3, desc[UR4][R2.64] ;                       /* 0x0000000402037981 */
                                                                                      /* 0x000ea2000c1e1900 */
        /*0110*/                   IADD3 R4, P0, R4, UR6, RZ ;                        /* 0x0000000604047c10 */
                                                                                      /* 0x000fc8000ff1e0ff */
        /*0120*/                   IADD3.X R5, R0, UR7, RZ, P0, !PT ;                 /* 0x0000000700057c10 */
                                                                                      /* 0x000fca00087fe4ff */
        /*0130*/                   STG.E desc[UR4][R4.64], R3 ;                       /* 0x0000000304007986 */
                                                                                      /* 0x004fe2000c101904 */
        /*0140*/                   EXIT ;                                             /* 0x000000000000794d */
                                                                                      /* 0x000fea0003800000 */
        /*0150*/                   BRA 0x150;                                         /* 0xfffffffc00fc7947 */
                                                                                      /* 0x000fc0000383ffff */
        /*0160*/                   NOP;                                               /* 0x0000000000007918 */
                                                                                      /* 0x000fc00000000000 */
        /*0170*/                   NOP;                                               /* 0x0000000000007918 */
                                                                                      /* 0x000fc00000000000 */
        /*0180*/                   NOP;                                               /* 0x0000000000007918 */
                                                                                      /* 0x000fc00000000000 */
        /*0190*/                   NOP;                                               /* 0x0000000000007918 */
                                                                                      /* 0x000fc00000000000 */



\t\tFunction : stream_sum_f32
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/               @P0 BRA 0x60 ;
        /*0030*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0040*/                   SHFL.DOWN PT, R5, R4, 0x10, 0x1f ;
        /*0050*/                   FADD R5, R4, R5 ;
        /*0060*/              @!P1 STS [R6], R5 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   LDS R7, [R8] ;
        /*0090*/                   SHFL.DOWN PT, R9, R7, 0x10, 0x1f ;
        /*00a0*/                   FADD R9, R7, R9 ;
        /*00b0*/               @P2 EXIT ;
        /*00c0*/                   STG.E desc[UR4][R10.64], R9 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
        /*00f0*/                   NOP;
\t\t..........


\t\tFunction : paged_decode_kernel_loop
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   IADD3 R0, R0, 0x80, RZ ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x400, PT ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
\t\t..........
"""


def test_census_splits_functions():
    fns = sc.split_functions(LISTING)
    assert list(fns) == ["stream_copy_f32", "stream_sum_f32",
                         "paged_decode_kernel_loop"]
    assert len(fns["stream_copy_f32"]) == 26           # 21 + BRA + 4 NOPs
    assert fns["stream_copy_f32"][8] == (0x80, "@P0 EXIT")
    assert fns["stream_copy_f32"][16] == (0x100, "LDG.E R3, desc[UR4][R2.64]")


def test_census_counts_a_straight_line_kernel():
    """Padding after the last EXIT dropped; every class counted; the
    predicated early EXIT counts as issued."""
    c = sc.census_text(LISTING, select="^stream_copy")["stream_copy_f32"]
    assert c.warp_insts_per_warp == 21
    assert c.counts == {"global_ldst": 2, "shared_ldst": 0, "fp": 0,
                        "int": 10, "shuffle": 0, "barrier": 0, "control": 2,
                        "other": 7}
    assert sum(c.counts.values()) == c.warp_insts_per_warp
    assert c.forward_branches == 0


def test_census_counts_shuffles_shared_and_barrier():
    c = sc.census_text(LISTING, select="^stream_sum")["stream_sum_f32"]
    assert c.warp_insts_per_warp == 14
    assert c.counts == {"global_ldst": 2, "shared_ldst": 2, "fp": 2,
                        "int": 0, "shuffle": 2, "barrier": 1, "control": 3,
                        "other": 2}
    assert c.forward_branches == 1


def test_census_raises_on_a_loop():
    with pytest.raises(sc.LoopError, match="backward branch at 0x30"):
        sc.census_text(LISTING)
    with pytest.raises(sc.LoopError):
        sc.census_text(LISTING, select="paged_")
    assert set(sc.census_text(LISTING, select="^stream_")) == {
        "stream_copy_f32", "stream_sum_f32"}


# The port's f32 dot kernel as nvcc 12.8 compiled it, in the compact form
# chip_smoke.py saves (address and instruction per line; NOPs cut): two
# shuffle trees around shared memory and a barrier, and lane 0 of every
# warp past the final predicated EXIT, so that every warp issues it all.
DOT_LISTING = """\
Function : stream_dot_f32
  /*0000*/ LDC R1, c[0x0][0x28] ;
  /*0010*/ S2R R5, SR_CTAID.X ;
  /*0020*/ HFMA2.MMA R3, -RZ, RZ, 0, 0 ;
  /*0030*/ ULDC.64 UR4, c[0x0][0x228] ;
  /*0040*/ ULDC.64 UR6, c[0x0][0x208] ;
  /*0050*/ S2R R2, SR_TID.X ;
  /*0060*/ IMAD.WIDE.U32 R6, R5, 0x400, R2 ;
  /*0070*/ ISETP.GE.U32.AND P0, PT, R6, UR4, PT ;
  /*0080*/ ISETP.GE.AND.EX P0, PT, R7, UR5, PT, P0 ;
  /*0090*/ @!P0 LDC.64 R8, c[0x0][0x210] ;
  /*00a0*/ @!P0 SHF.L.U32 R3, R6.reuse, 0x2, RZ ;
  /*00b0*/ @!P0 SHF.L.U64.HI R0, R6, 0x2, R7 ;
  /*00c0*/ @!P0 LDC.64 R10, c[0x0][0x218] ;
  /*00d0*/ @!P0 IADD3 R8, P1, R3, R8, RZ ;
  /*00e0*/ @!P0 IMAD.X R9, R0, 0x1, R9, P1 ;
  /*00f0*/ @!P0 IADD3 R6, P2, R3, R10, RZ ;
  /*0100*/ @!P0 LDG.E R9, desc[UR6][R8.64] ;
  /*0110*/ @!P0 IADD3.X R7, R0, R11, RZ, P2, !PT ;
  /*0120*/ @!P0 LDG.E R6, desc[UR6][R6.64] ;
  /*0130*/ IMAD.MOV.U32 R0, RZ, RZ, RZ ;
  /*0140*/ S2UR UR5, SR_CgaCtaId ;
  /*0150*/ UMOV UR4, 0x400 ;
  /*0160*/ ULEA UR4, UR5, UR4, 0x18 ;
  /*0170*/ @!P0 FMUL R0, R6, R9 ;
  /*0180*/ SHFL.DOWN PT, R3, R0, 0x10, 0x1f ;
  /*0190*/ FADD R3, R3, R0 ;
  /*01a0*/ SHFL.DOWN PT, R4, R3, 0x8, 0x1f ;
  /*01b0*/ FADD R4, R3, R4 ;
  /*01c0*/ SHFL.DOWN PT, R11, R4, 0x4, 0x1f ;
  /*01d0*/ FADD R11, R4, R11 ;
  /*01e0*/ SHFL.DOWN PT, R10, R11, 0x2, 0x1f ;
  /*01f0*/ LOP3.LUT P0, R6, R2, 0x1f, RZ, 0xc0, !PT ;
  /*0200*/ FADD R10, R11, R10 ;
  /*0210*/ SHFL.DOWN PT, R7, R10, 0x1, 0x1f ;
  /*0220*/ @!P0 SHF.R.U32.HI R2, RZ, 0x3, R2 ;
  /*0230*/ @!P0 LOP3.LUT R2, R2, 0x1ffffffc, RZ, 0xc0, !PT ;
  /*0240*/ FADD R9, R10, R7 ;
  /*0250*/ @!P0 STS [R2+UR4], R9 ;
  /*0260*/ LEA R6, R6, UR4, 0x2 ;
  /*0270*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;
  /*0280*/ LDS R6, [R6] ;
  /*0290*/ SHFL.DOWN PT, R3, R6, 0x10, 0x1f ;
  /*02a0*/ FADD R3, R6, R3 ;
  /*02b0*/ SHFL.DOWN PT, R0, R3, 0x8, 0x1f ;
  /*02c0*/ FADD R0, R3, R0 ;
  /*02d0*/ SHFL.DOWN PT, R7, R0, 0x4, 0x1f ;
  /*02e0*/ FADD R7, R0, R7 ;
  /*02f0*/ SHFL.DOWN PT, R4, R7, 0x2, 0x1f ;
  /*0300*/ FADD R4, R7, R4 ;
  /*0310*/ SHFL.DOWN PT, R9, R4, 0x1, 0x1f ;
  /*0320*/ @P0 EXIT ;
  /*0330*/ LDC.64 R2, c[0x0][0x220] ;
  /*0340*/ FADD R9, R4, R9 ;
  /*0350*/ LEA R2, P0, R5, R2, 0x2 ;
  /*0360*/ LEA.HI.X R3, R5, R3, RZ, 0x2, P0 ;
  /*0370*/ STG.E desc[UR6][R2.64], R9 ;
  /*0380*/ EXIT ;
  /*0390*/ BRA 0x390 ;
"""


def test_census_of_the_dot_kernel():
    c = sc.census_text(DOT_LISTING)["stream_dot_f32"]
    assert c.warp_insts_per_warp == 57
    assert c.counts == {"global_ldst": 3, "shared_ldst": 2, "fp": 12,
                        "int": 17, "shuffle": 10, "barrier": 1,
                        "control": 2, "other": 10}
    assert c.forward_branches == 0


@pytest.mark.parametrize("body,err", [
    ("        /*0000*/                   BRX R2 -0x10 ;\n"
     "        /*0010*/                   EXIT ;\n", sc.LoopError),
    ("        /*0000*/                   BRA `(.L_x_0) ;\n"
     "        /*0010*/                   EXIT ;\n", sc.LoopError),
    ("        /*0000*/                   NOP ;\n", ValueError),
], ids=["indirect", "unresolved-target", "no-exit"])
def test_census_refuses_what_it_cannot_count(body, err):
    with pytest.raises(err):
        sc.census_text("\t\tFunction : k\n" + body)


@pytest.mark.parametrize("base,cls", [
    ("LDG", "global_ldst"), ("STG", "global_ldst"), ("LDS", "shared_ldst"),
    ("FFMA", "fp"), ("F2FP", "fp"), ("IMAD", "int"), ("UIADD3", "int"),
    ("SHFL", "shuffle"), ("BAR", "barrier"), ("BSSY", "control"),
    ("MOV", "other"), ("S2R", "other")])
def test_opcode_classes(base, cls):
    assert sc.opcode_class(base) == cls


def test_find_cuobjdump_raises_without_one(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(sc.shutil, "which", lambda name: None)
    monkeypatch.setattr(sc.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        sc.find_cuobjdump()


def _result(n, ms):
    """A BabelStream result over n f32 elements whose every iteration took
    ``ms[name]`` milliseconds (the first iteration slower)."""
    times = {k: [1.0] + [v / 1e3] * 3 for k, v in ms.items()}
    return babelstream.Result(n=n, dtype=torch.float32, num_times=4,
                              device="cuda:0", times=times, sum=0.0,
                              gold_sum=0.0, errors={}, limits={})


def test_h100_irm_arithmetic():
    """Instructions = path length x warps launched (x 32 threads, which
    Eq. 4 divides out again): copy, mul, add and triad one 16-byte
    vector (4 f32 elements) a thread; the copy point sits
    exactly on the memory roof its own rate defines; dot sums the paths
    of its two launches (32 elements a thread in blocks of 8 warps: 4096
    blocks, then one)."""
    n = 2 ** 25
    paths = {"stream_copy_f32": 16, "stream_mul_f32": 18,
             "stream_add_f32": 20, "stream_triad_f32": 24,
             "stream_dot_f32": 60, "stream_sum_f32": 50}
    census = {k: sc.KernelCensus(k, v, {}, 0) for k, v in paths.items()}
    ms = {"copy": 0.0900, "mul": 0.0910, "add": 0.1300, "triad": 0.1290,
          "dot": 0.1000}
    res = _result(n, ms)
    hw = hardware.h100_spec("H100", 132, 1980.0, 80 * 2 ** 30,
                            measured_gbs=res.copy_gbs())
    model, rows = launch_irm.h100_irm(hw, census, res)
    by = {r["kernel"]: r for r in rows}
    warps = n // 32
    assert by["copy"]["warp_insts"] == 16 * warps // 4
    assert by["mul"]["warp_insts"] == 18 * warps // 4
    assert by["add"]["warp_insts"] == 20 * warps // 4
    assert by["triad"]["warp_insts"] == 24 * warps // 4
    assert by["dot"]["warp_insts"] == 60 * warps // 32 + 50 * 1 * 8
    assert by["copy"]["bytes"] == 2 * 4 * n and by["add"]["bytes"] == 12 * n
    assert close(res.copy_gbs(), 8 * n / 0.09e-3 / 1e9)
    for name, r in by.items():
        assert close(r["inst_per_byte"], r["warp_insts"] / r["bytes"])
        assert close(r["achieved_gips"], r["warp_insts"] / (ms[name] * 1e6))
        assert close(r["roof_gips"], min(hw.peak_gips(), r["inst_per_byte"]
                                         * res.copy_gbs()))
        assert r["bound"] == "memory"
    assert close(by["copy"]["achieved_over_roof"], 1.0)
    assert close(model.knee(), hw.peak_gips() / res.copy_gbs())
    assert set(launch_irm.IRM_COLUMNS) == set(rows[0])


def test_h100_report_prints_points_above_the_roof(monkeypatch):
    """The report: the spec, the clock line as read, the table, and one
    line for every point above its roof (add and triad move more bytes
    per second than copy here), none clamped."""
    n = 2 ** 25
    census = {f"stream_{k}_f32": sc.KernelCensus(k, 20, {}, 0)
              for k in babelstream.FUNCTIONS + ("sum",)}
    res = _result(n, {"copy": 0.0900, "mul": 0.0950, "add": 0.1300,
                      "triad": 0.1310, "dot": 0.1000})
    monkeypatch.setattr(launch_irm, "h100_from_device",
                        lambda gbs: hardware.h100_spec(
                            "H100", 132, 1980.0, 80 * 2 ** 30,
                            measured_gbs=gbs))
    lines = launch_irm.h100_report(census, res, "1980 MHz, 1980 MHz")
    assert lines[0].startswith("H100: 132 SMs x 4 schedulers")
    assert f"{res.copy_gbs():.3f} GB/s" in lines[0]
    assert lines[1].endswith("1980 MHz, 1980 MHz")
    assert lines[2].split("|")[1].strip() == "kernel"
    above = [ln.split()[0] for ln in lines if "above its roof" in ln]
    assert above == ["add", "triad"]
    ratio = (12 / 0.1300) / (8 / 0.0900)
    assert f"achieved/roof = {ratio:.4f}" in lines[-2]


def test_h100_irm_needs_whole_warps():
    """An elementwise kernel over n not a multiple of its block's elements
    has warps that leave at a bounds guard, which one path per kernel
    cannot count: 4096 f32 elements for copy, mul, add and triad (1024
    threads of one 16-byte vector)."""
    hw = hardware.h100_spec("H100", 132, 1980.0, 0, measured_gbs=1.0)
    census = {f"stream_{k}_f32": sc.KernelCensus(k, 9, {}, 0)
              for k in babelstream.FUNCTIONS + ("sum",)}
    for n in (3000, 5 * 1024, 3 * 4096 + 1024):
        res = _result(n, dict.fromkeys(babelstream.FUNCTIONS, 0.01))
        with pytest.raises(ValueError, match="copy: .* multiple of the 4096 "
                                             "elements"):
            launch_irm.h100_irm(hw, census, res)
        with pytest.raises(ValueError, match="mul: .* multiple of the 4096 "
                                             "elements"):
            launch_irm.warp_instructions("mul", census, res)
        for name in ("add", "triad"):
            with pytest.raises(ValueError, match=f"{name}: .* multiple of "
                                                 f"the 4096 elements"):
                launch_irm.warp_instructions(name, census, res)
    res = _result(3 * 4096, dict.fromkeys(babelstream.FUNCTIONS, 0.01))
    assert launch_irm.warp_instructions("copy", census, res) == 9 * 3 * 32
    assert launch_irm.warp_instructions("add", census, res) == 9 * 3 * 32
    assert launch_irm.warp_instructions("triad", census, res) == 9 * 3 * 32
    launch_irm.h100_irm(hw, census, res)


def test_h100_irm_needs_every_kernel_in_the_census():
    res = _result(4096, dict.fromkeys(babelstream.FUNCTIONS, 0.01))
    hw = hardware.h100_spec("H100", 132, 1980.0, 0, measured_gbs=1.0)
    census = {"stream_copy_f32": sc.KernelCensus("stream_copy_f32", 9, {},
                                                 0)}
    with pytest.raises(KeyError, match="stream_mul_f32"):
        launch_irm.h100_irm(hw, census, res)
    assert stream.VEC_THREADS // 32 == 32


def test_paper_rows_recompute_tables():
    rows = launch_irm.paper_rows()
    assert len(rows) == 6
    for r in rows:
        table = jdata.TABLE1 if r["table"] == "table1_lwfa" else jdata.TABLE2
        m = table[r["gpu"]]
        assert close(r["achieved_gips"], m.achieved_gips())
        assert close(r["intensity"], m.intensity_performance())
        assert r["peak_gips"] == pytest.approx(r["peak_gips_published"],
                                               abs=0.01)


def test_irm_launcher_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.irm", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("table1_lwfa") == 3
    assert res.stdout.count("table2_tweac") == 3


def _model(ms_copy=0.09):
    n = 2 ** 25
    res = _result(n, {"copy": ms_copy, "mul": 0.091, "add": 0.13,
                      "triad": 0.129, "dot": 0.1})
    hw = hardware.h100_spec("H100", 132, 1980.0, 80 * 2 ** 30,
                            measured_gbs=res.copy_gbs())
    census = {k: sc.KernelCensus(k, 20, {}, 0) for k in (
        "stream_copy_f32", "stream_mul_f32", "stream_add_f32",
        "stream_triad_f32", "stream_dot_f32", "stream_sum_f32")}
    return launch_irm.h100_irm(hw, census, res)[0]


def test_app_rows_place_points_at_hi():
    """A looped kernel's point: both intensities, GIPS at lo and hi, the
    roof and achieved/roof at hi; memory or compute by the knee."""
    model = _model()
    pts = [launch_irm.AppPoint("k: a", 1000, 3000, 10000, 1e-6),
           launch_irm.AppPoint("k: b", 10 ** 9, 2 * 10 ** 9, 10 ** 9, 1e-2)]
    rows = launch_irm.app_rows(model, pts)
    a, b = rows
    assert close(a["inst_per_byte_lo"], 0.1) and close(a["inst_per_byte_hi"],
                                                       0.3)
    assert close(a["achieved_gips_lo"], 1.0) and close(a["achieved_gips"],
                                                       3.0)
    assert close(a["roof_gips"], model.roof_at(0.3))
    assert close(a["achieved_over_roof"], 3.0 / model.roof_at(0.3))
    assert a["bound"] == "memory" and b["bound"] == "compute"
    assert set(launch_irm.APP_COLUMNS) == set(a)
    assert launch_irm.over_peak(model.hw, rows) == []
    fast = launch_irm.AppPoint("k: c", 2 * 10 ** 12, 2 * 10 ** 12, 10 ** 9,
                               1.0)
    assert len(launch_irm.over_peak(
        model.hw, launch_irm.app_rows(model, [fast]))) == 1
    assert "knee" in launch_irm.app_report(model, pts)[0]


def test_kernel_names_and_trace_keys():
    """A launch's kernel is found in a profiler trace by its C++ name."""
    from repro_torch.kernels.decode_attention import paged as kpaged
    split, comb = kpaged.trip_model(1, 32, 8, 128, 16, 4, [9],
                                    torch.bfloat16, torch.bfloat16)
    assert launch_irm.kernel_name(split) == "paged_decode_kernel"
    assert launch_irm.kernel_name(comb) == "decode_attention_combine_kernel"
    times = {"void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16,"
             " __nv_bfloat16, 128>((anonymous namespace)::Params)": (9.0, 1),
             "void (anonymous namespace)::splitkv::decode_attention_combine"
             "_kernel<__nv_bfloat16>(CombineParams)": (4.0, 1)}
    assert launch_irm.kernel_us(times, split) == (9.0, 1)
    assert launch_irm.kernel_us(times, comb) == (4.0, 1)
    with pytest.raises(KeyError):
        launch_irm.kernel_us({}, split)


@pytest.mark.parametrize("traces,tries,ok", [
    ([36, 36], 1, True), ([18, 36], 2, True), ([18, 0, 36], 3, True),
    ([18, 18, 18], 3, False), ({}, 3, False)])
def test_app_points_reads_only_a_trace_with_every_launch(monkeypatch,
                                                          traces, tries, ok):
    """A trace that misses launches of the case's calls (the profiler
    drops some) is taken again; a point is read only from one that holds
    them all, and ``TRACE_TRIES`` short traces raise."""
    from repro_torch.kernels.decode_attention import paged as kpaged
    split, comb = kpaged.trip_model(1, 32, 8, 128, 16, 4, [9],
                                    torch.bfloat16, torch.bfloat16)
    keys = {"split": "void paged_decode_kernel<__nv_bfloat16>(Params)",
            "comb": "void decode_attention_combine_kernel<float>(P)"}
    # a list: the split kernel's launches in each trace, the combine's all
    # there; a dict: every trace without the split kernel
    seq = ([36] * 3 if isinstance(traces, dict) else list(traces))
    taken = []

    def device_us(torch_, call, iters):
        n = seq[len(taken)]
        taken.append(n)
        out = {keys["comb"]: (72.0, iters)}
        if not isinstance(traces, dict) and n:
            out[keys["split"]] = (2.0 * n, n)
        return out

    monkeypatch.setattr(launch_irm, "device_us", device_us)
    counter = types.SimpleNamespace(count=lambda la: (10, 20))
    case = launch_irm.AppCase("paged_decode", lambda i: None, [split, comb])
    if not ok:
        with pytest.raises(AssertionError, match="3 traces of 36 calls"):
            launch_irm.app_points(torch, counter, [case], iters=36)
        assert len(taken) == launch_irm.TRACE_TRIES
        return
    pts = launch_irm.app_points(torch, counter, [case], iters=36)
    assert len(taken) == tries
    assert [p.kernel for p in pts] == [
        "paged_decode: paged_decode_kernel",
        "paged_decode: decode_attention_combine_kernel", "paged_decode: sum"]
    assert pts[0].seconds == pytest.approx(2.0 * 36 / 36 * 1e-6)
    assert pts[1].seconds == pytest.approx(72.0 / 36 * 1e-6)


def test_serve_shapes_are_the_serve_phase_lengths():
    assert launch_irm.serve_shapes() == ([255, 276, 105, 147],
                                         [224, 256, 64, 128], 21)
