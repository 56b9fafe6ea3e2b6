"""The loop census (``core/sass_counters.py``: ``loop_census``,
``count_looped``) on listings written here in ``cuobjdump`` form, with
their source lines as ``nvdisasm -g`` gives them: one loop behind a
predicated EXIT, nested loops, a forward branch inside a loop (lo < hi),
nvcc's unroll-by-4 main loop with its remainder loop, and what it refuses
(a back edge in no marked loop, an indirect branch, an irreducible loop,
an unroll factor read two ways).  Then the census on the real SASS of the
bf16 selective scan and paged decode kernel
(``test_torch_sass_listings.py``): their loops found, tied to the marked
source loops of ``src/repro_torch/csrc``, the scan's step loop unrolled
by 4, and their counts at the shapes of PERF.md's kernel table.
"""
import pytest
import torch

from repro_torch.core import sass_counters as sc
from repro_torch.kernels.decode_attention import paged
from repro_torch.kernels.ssm_scan import scan
from repro_torch.launch import irm

from test_torch_sass_listings import (
    PAGED_DECODE_BF16, PAGED_DECODE_BF16_NAME, SCAN_BF16, SCAN_BF16_NAME,
    parse)


def loops(*specs):
    """Marked source loops of a made-up ``k.cu``: (name, for line, end
    line, step, pragma)."""
    return {n: sc.SourceLoop(name=n, file="k.cu", line=a, end=b, step=s,
                             pragma=p) for n, a, b, s, p in specs}


def total(d):
    return sum(d.values())


# for (i = 0; i < n; ++i) acc += x[i], behind `if (n < 1) return`
ONE_LOOP = """\
@k.cu:10
/*0000*/ LDC R2, c[0x0][0x210] ;
/*0010*/ ISETP.GE.AND P0, PT, R2, 0x1, PT ;
/*0020*/ @!P0 EXIT ;
/*0030*/ MOV R3, RZ ;
@k.cu:22
/*0040*/ LDG.E R4, desc[UR4][R6.64] ;
/*0050*/ FADD R5, R5, R4 ;
@k.cu:20
/*0060*/ IADD3 R3, R3, 0x1, RZ ;
/*0070*/ ISETP.GE.AND P0, PT, R3, R2, PT ;
/*0080*/ @!P0 BRA 0x40 ;
@k.cu:30
/*0090*/ STG.E desc[UR4][R8.64], R5 ;
/*00a0*/ EXIT ;
/*00b0*/ BRA 0xb0 ;
"""


def test_one_loop_behind_a_predicated_exit():
    """The loop's 5 instructions per trip, scaled by its trip count; the
    straight-line part runs 3 (the early EXIT) or 6 instructions."""
    insts, lines = parse(ONE_LOOP)
    src = loops(("L1", 20, 24, 1, None))
    c = sc.loop_census("k", insts, lines, src)
    (lp,) = c.loops
    assert (lp.header, lp.back_edges, lp.source, lp.where, lp.unroll) == (
        0x40, (0x80,), "L1", "k.cu:20", 1)
    assert total(lp.lo) == total(lp.hi) == 5
    assert (total(c.top_lo), total(c.top_hi)) == (3, 6)
    lo, hi = sc.count_looped("k", insts, {"L1": [5]}, lines=lines,
                             sources=src)
    assert (total(lo), total(hi)) == (28, 31)
    assert lo["global_ldst"] == 5 and hi["global_ldst"] == 6
    lo, hi = c.count({"L1": [5, 0, 2]}, warps=3)      # three warps
    assert (total(lo), total(hi)) == (9 + 35, 18 + 35)


NESTED = """\
@k.cu:40
/*0000*/ MOV R2, RZ ;
@k.cu:41
/*0010*/ MOV R3, RZ ;
@k.cu:44
/*0020*/ FFMA R5, R5, R6, R7 ;
@k.cu:42
/*0030*/ IADD3 R3, R3, 0x1, RZ ;
/*0040*/ ISETP.GE.AND P0, PT, R3, R8, PT ;
/*0050*/ @!P0 BRA 0x20 ;
@k.cu:40
/*0060*/ IADD3 R2, R2, 0x1, RZ ;
/*0070*/ ISETP.GE.AND P1, PT, R2, R9, PT ;
/*0080*/ @!P1 BRA 0x10 ;
/*0090*/ EXIT ;
"""


def test_nested_loops():
    """The inner loop's trips per entry may differ from one outer trip to
    the next: 3 outer trips of 4 instructions, 1 + 2 + 3 inner trips of
    4, and 2 outside."""
    insts, lines = parse(NESTED)
    src = loops(("outer", 40, 50, 1, None), ("inner", 42, 46, 1, None))
    c = sc.loop_census("k", insts, lines, src)
    by = {lp.source: lp for lp in c.loops}
    assert by["inner"].parent == by["outer"].header == 0x10
    assert by["inner"].header == 0x20 and by["outer"].parent is None
    assert total(by["outer"].lo) == total(by["inner"].lo) == 4
    lo, hi = c.count({"outer": [3], "inner": [1, 2, 3]}, warps=1)
    assert total(lo) == total(hi) == 2 + 3 * 4 + 6 * 4


BRANCHY = """\
@k.cu:20
/*0000*/ MOV R3, RZ ;
/*0010*/ ISETP.GE.AND P1, PT, R3, R4, PT ;
/*0020*/ @P1 BRA 0x50 ;
@k.cu:23
/*0030*/ FMUL R5, R5, R6 ;
/*0040*/ FADD R5, R5, R7 ;
@k.cu:20
/*0050*/ IADD3 R3, R3, 0x1, RZ ;
/*0060*/ ISETP.GE.AND P0, PT, R3, R2, PT ;
/*0070*/ @!P0 BRA 0x10 ;
/*0080*/ EXIT ;
"""


def test_forward_branch_inside_a_loop_opens_the_interval():
    insts, lines = parse(BRANCHY)
    src = loops(("L1", 20, 26, 1, None))
    (lp,) = sc.loop_census("k", insts, lines, src).loops
    assert (total(lp.lo), total(lp.hi)) == (5, 7)
    assert lp.hi["fp"] - lp.lo["fp"] == 2
    lo, hi = sc.count_looped("k", insts, {"L1": [4]}, lines=lines,
                             sources=src)
    assert (total(lo), total(hi)) == (22, 30)


# #pragma unroll 4 over for (t = 0; t < n; ++t): nvcc's main loop of 4
# copies while 4 or more trips remain, counting n - n % 4 down by 4, then
# a remainder loop counting n % 4 down by 1
UNROLLED = """\
@k.cu:60
/*0000*/ LDC R2, c[0x0][0x210] ;
/*0010*/ ISETP.GE.AND P0, PT, R2, 0x1, PT ;
/*0020*/ @!P0 EXIT ;
/*0030*/ LOP3.LUT R3, R2, 0x3, RZ, 0xc0, !PT ;
/*0040*/ ISETP.GE.U32.AND P0, PT, R2, 0x4, PT ;
/*0050*/ @!P0 BRA 0xe0 ;
/*0060*/ IADD3 R4, R2, -R3, RZ ;
@k.cu:62
/*0070*/ LDS R5, [R6] ;
/*0080*/ LDS R7, [R6+0x4] ;
/*0090*/ LDS R8, [R6+0x8] ;
/*00a0*/ LDS R9, [R6+0xc] ;
@k.cu:60
/*00b0*/ IADD3 R4, R4, -0x4, RZ ;
/*00c0*/ ISETP.NE.AND P0, PT, R4, RZ, PT ;
/*00d0*/ @P0 BRA 0x70 ;
/*00e0*/ ISETP.NE.AND P0, PT, R3, RZ, PT ;
/*00f0*/ @!P0 EXIT ;
@k.cu:62
/*0100*/ LDS R5, [R6] ;
@k.cu:60
/*0110*/ IADD3 R3, R3, -0x1, RZ ;
/*0120*/ ISETP.NE.AND P0, PT, R3, RZ, PT ;
/*0130*/ @P0 BRA 0x100 ;
/*0140*/ EXIT ;
"""


def test_unrolled_main_loop_and_its_remainder():
    """The factor read three ways (the counter's step, the copies of the
    body against the remainder loop, the pragma), and n = 6 split into 1
    main and 2 remainder trips."""
    insts, lines = parse(UNROLLED)
    src = loops(("U", 60, 64, 1, 4))
    c = sc.loop_census("k", insts, lines, src)
    main, rem = sorted(c.loops, key=lambda lp: -lp.unroll)
    assert (main.unroll, main.header, total(main.lo)) == (4, 0x70, 7)
    assert (rem.unroll, rem.header, total(rem.lo)) == (1, 0x100, 4)
    assert (total(c.top_lo), total(c.top_hi)) == (3, 10)
    lo, hi = c.count({"U": [6]}, warps=1)
    assert (total(lo), total(hi)) == (3 + 7 + 2 * 4, 10 + 7 + 2 * 4)
    lo, hi = c.count({"U": [8]}, warps=1)             # no remainder trip
    assert total(lo) == 3 + 2 * 7


def test_census_refuses_an_unroll_factor_read_two_ways():
    insts, lines = parse(UNROLLED)
    with pytest.raises(sc.LoopError, match="read two ways"):
        sc.loop_census("k", insts, lines, loops(("U", 60, 64, 1, 2)))


def test_census_refuses_a_back_edge_in_no_marked_loop():
    insts, lines = parse(ONE_LOOP)
    with pytest.raises(sc.LoopError, match=r"0x80 \(k.cu:20\) lies in no "
                                           r"loop marked REPRO_TRIP"):
        sc.loop_census("k", insts, lines, loops(("L1", 21, 24, 1, None)))
    with pytest.raises(sc.LoopError, match="no source line"):
        sc.loop_census("k", insts, {}, loops(("L1", 20, 24, 1, None)))


def test_census_refuses_an_indirect_branch():
    insts, lines = parse("@k.cu:1\n/*0000*/ MOV R2, RZ ;\n"
                         "/*0010*/ BRX R2 -0x20 ;\n/*0020*/ EXIT ;\n")
    with pytest.raises(sc.LoopError, match="indirect branch at 0x10"):
        sc.loop_census("k", insts, lines, {})


def test_census_refuses_an_irreducible_loop():
    """A cycle entered at both of its blocks has no header."""
    insts, lines = parse("@k.cu:1\n/*0000*/ @P0 BRA 0x30 ;\n"
                         "/*0010*/ FADD R1, R1, R2 ;\n"
                         "/*0020*/ @P1 BRA 0x50 ;\n"
                         "/*0030*/ FADD R3, R3, R4 ;\n"
                         "/*0040*/ @P2 BRA 0x10 ;\n/*0050*/ EXIT ;\n")
    with pytest.raises(sc.LoopError, match="irreducible"):
        sc.loop_census("k", insts, lines, loops(("L", 1, 9, 1, None)))


def test_census_needs_every_loops_trips():
    insts, lines = parse(ONE_LOOP)
    c = sc.loop_census("k", insts, lines, loops(("L1", 20, 24, 1, None)))
    with pytest.raises(KeyError, match=r"REPRO_TRIP\(L1\)"):
        c.count({}, warps=1)


def test_straight_line_kernels_still_refuse_loops():
    """``count_function`` keeps its contract: a loop is a LoopError."""
    insts, _ = parse(ONE_LOOP)
    with pytest.raises(sc.LoopError, match="backward branch"):
        sc.count_function("k", insts)


def test_source_loops_of_the_port():
    """Every REPRO_TRIP marker of csrc opens a for loop's body; the scan's
    step loop carries its #pragma unroll 4; steps resolve from literals
    and constexprs, not from a template's."""
    src = sc.source_loops()
    assert len(src) == 43
    assert {s.file for s in src.values()} == {
        "split_decode.cuh", "attention_tc.cuh", "selective_scan.cu",
        "flash_attention.cu", "paged_attention.cuh"}
    s = src["scan_steps"]
    assert (s.file, s.pragma, s.step) == ("selective_scan.cu", 4, 1)
    assert src["split_kv_copy"].step == 128 and \
        src["combine_out"].step == 512
    assert src["split_pv"].pragma == 2 and src["combine_sum"].pragma == 8
    assert src["tc_kv_copy"].step is None          # 32 * WARPS
    assert src["tc_out"].step == 32
    assert src["flash_qk"].pragma == 8 and src["flash_tiles"].step == 32
    assert src["paged_row_tiles"].step is None     # ROWS, a template's


def test_parse_source_loops_refuses_a_stray_marker():
    with pytest.raises(ValueError, match="first statement"):
        sc.parse_source_loops("k.cu", "void f() {\n  int a = 0;\n"
                                      "  REPRO_TRIP(x);\n}\n")


def test_parse_line_info_reads_nvdisasm():
    text = ('.text._Z1kv:\n'
            '\t//## File "/src/csrc/k.cu", line 12\n'
            '        /*0000*/                   LDC R1, c[0x0][0x28] ;\n'
            '        /*0010*/                   S2R R0, SR_TID.X ;\n'
            '\t//## File "/src/csrc/k.cuh", line 3 inlined at "k.cu", '
            'line 12\n'
            '        /*0020*/                   EXIT ;\n')
    assert sc.parse_line_info(text) == {"_Z1kv": {
        0x0: ("k.cu", 12), 0x10: ("k.cu", 12), 0x20: ("k.cuh", 3)}}


def test_real_scan_listing():
    """The bf16 scan at N 16 over 2 lanes: its loops tied to the four
    marked loops, the step loop (selective_scan.cu's ``#pragma unroll 4``
    over nt = min(kT, S - i kT)) unrolled by 4 beside its remainder loop,
    both inside the tile loop; and the count at falcon-mamba-7b's shape
    (B 4, S 454, d_in 8192: 2048 warps, 14 tiles of 32 steps and one of
    6), whose lo and hi bracket 14-20 instructions per exponential."""
    insts, lines = parse(SCAN_BF16)
    c = sc.loop_census(SCAN_BF16_NAME, insts, lines, sc.source_loops())
    assert c.sources() == ["scan_steps", "scan_tiles", "scan_xdt_copy",
                           "scan_xdt_load"]
    line = sc.source_loops()["scan_steps"].line
    steps = [lp for lp in c.loops if lp.source == "scan_steps"]
    assert sorted(lp.unroll for lp in steps) == [1, 4]
    assert all(lp.where == f"selective_scan.cu:{line}" for lp in steps)
    tiles = [lp for lp in c.loops if lp.source == "scan_tiles"]
    assert len(tiles) == 1 and all(lp.parent == tiles[0].header
                                   for lp in steps)
    (la,) = scan.trip_model(4, 454, 8192, 16, torch.bfloat16)
    lo, hi = c.count(la.entries(), la.warps)
    assert (total(lo), total(hi)) == (104458240, 129767424)
    exps = 4 * 454 * 8192 * 16 // 32               # warp exponentials
    assert 14 <= total(lo) / exps and total(hi) / exps <= 20


def test_real_paged_decode_listing():
    """The bf16 paged decode kernel at D 128: the row-tile loop around
    the K/V copies, the query load (unrolled by 16) and the tile loop,
    which holds a copy loop and four copies of p @ v's loop (one per
    4-column unit, unrolled by 2 by its pragma); the count at the
    ``serve`` phase's lengths."""
    insts, lines = parse(PAGED_DECODE_BF16)
    c = sc.loop_census(PAGED_DECODE_BF16_NAME, insts, lines,
                       sc.source_loops())
    by = {}
    for lp in c.loops:
        by.setdefault(lp.source, []).append(lp)
    assert sorted(by) == ["split_kv_copy", "split_kv_tiles", "split_pv",
                          "split_q_load", "split_row_tiles"]
    rows, tiles = by["split_row_tiles"][0], by["split_kv_tiles"][0]
    assert rows.parent is None and tiles.parent == rows.header
    assert [lp.unroll for lp in by["split_pv"]] == [2] * 4
    assert all(lp.parent == tiles.header for lp in by["split_pv"])
    assert by["split_q_load"][0].unroll == 16
    assert {lp.unroll for lp in by["split_kv_copy"]} == {4}
    lens, _, NB = irm.serve_shapes()
    split, _ = paged.trip_model(4, 32, 8, 128, 16, NB, lens, torch.bfloat16,
                                torch.bfloat16)
    lo, hi = c.count(split.entries(), split.warps)
    assert 0 < total(lo) < total(hi)
    assert (total(lo), total(hi)) == (765952, 4013056)
