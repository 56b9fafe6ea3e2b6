"""The port's three-term roofline, H100 step profile, step IRM and SVG
figure on the CPU, by hand and against the JAX package's
``roofline_terms`` on the same census numbers.

  * the three cases of ``tests/test_irm_roofline.py`` (dominant
    selection, 1 s per term by hand, MFU from model FLOPs) on the
    H100's ceilings;
  * ``roofline_terms`` field for field against the JAX function, its
    ``HardwareSpec`` built with the H100's constants, on censuses with
    no f32 product; f32 products priced at the f32 peak by hand;
  * ``profile_from_census`` and ``step_irm`` by hand;
  * the H100 ceilings: 132 SMs at 1980 MHz give Eq. 3's 1045.44 GIPS and
    a tensor-core peak of 132 x 4 x 1024 x 1.98e9 FLOP/s;
  * ``plot_irm``'s SVG parsed: every ceiling's and point's coordinates
    are the log mapping of the model's values; a non-.svg path refused.
"""
import math
import xml.etree.ElementTree as ET

import pytest

from torch_one_thread import _one_thread  # noqa: F401  (autouse)

from repro_torch.core.gpu_model import profile_from_census
from repro_torch.core.hardware import h100_spec
from repro_torch.core.irm import step_irm
from repro_torch.core.roofline import roofline_terms, to_row
from repro_torch.core.step_census import Census, CollectiveStat

H100 = h100_spec("NVIDIA H100 80GB HBM3", 132, 1980.0, 80 * 2 ** 30)
PEAK = 132 * 4 * 1024 * 1.98e9


def _census(flops=1e12, hbm=1e11, wire=1e9):
    c = Census()
    c.flops = flops
    c.tc_flops = flops
    c.hbm_bytes = hbm
    c.tc_issues = flops / 4096
    c.warp_issues = 1e6
    c.collectives["all-reduce"] = CollectiveStat("all-reduce", 1, wire, wire)
    return c


def test_h100_ceilings():
    assert H100.peak_gips() == pytest.approx(1045.44)
    assert H100.peak_warp_issues_per_s() == pytest.approx(1045.44e9)
    assert H100.peak_flops_bf16 == pytest.approx(PEAK)
    assert H100.flops_per_tc_issue() == 4096
    assert H100.peak_tc_issues_per_s() == pytest.approx(PEAK / 4096)
    assert H100.peak_tc_issues_per_s() * H100.flops_per_tc_issue() \
        == pytest.approx(H100.peak_flops_bf16)
    assert H100.peak_flops_fp32 == pytest.approx(132 * 128 * 2 * 1.98e9)
    assert (H100.links, H100.link_bw_per_link_gbs) == (18, 25.0)
    assert H100.memory_ceiling_gbs() == 3352.0


def test_roofline_dominant_selection():
    t = roofline_terms("c", _census(flops=1e15, hbm=1e9, wire=1e6), H100, 1)
    assert t.dominant == "compute"
    t = roofline_terms("m", _census(flops=1e9, hbm=1e12, wire=1e6), H100, 1)
    assert t.dominant == "memory"
    t = roofline_terms("x", _census(flops=1e9, hbm=1e6, wire=1e12), H100, 1)
    assert t.dominant == "collective"


def test_roofline_terms_match_hand_math():
    t = roofline_terms("h", _census(flops=PEAK, hbm=3352e9, wire=450e9),
                       H100, 1)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)      # 18 links x 25 GB/s


def test_mfu_uses_model_flops():
    t = roofline_terms("u", _census(flops=PEAK, hbm=1.0, wire=0.0), H100,
                       n_devices=4, model_flops_total=4 * PEAK / 2)
    # modeled time 1 s; useful flops per device = PEAK / 2 -> MFU 0.5
    assert t.mfu_vs_peak == pytest.approx(0.5)
    assert t.useful_flops_ratio == pytest.approx(0.5)


def test_f32_products_at_the_f32_peak():
    """The card runs f32 products on its CUDA cores (TF32 off): of a
    census's PEAK tensor-core FLOPs, the fp32 peak's worth in f32 take
    1 s on their own and the rest (PEAK - fp32) / PEAK s."""
    fp32 = H100.peak_flops_fp32
    c = _census(flops=PEAK, hbm=1.0, wire=0.0)
    c.tc_flops_f32 = fp32
    t = roofline_terms("f", c, H100, 1)
    assert t.compute_s == pytest.approx(1.0 + (PEAK - fp32) / PEAK)
    assert t.dominant == "compute"


@pytest.mark.parametrize("numbers", [(1e15, 1e9, 1e6), (1e9, 1e12, 1e6),
                                     (1e9, 1e6, 1e12), (3e13, 2e11, 4e9)])
def test_roofline_terms_against_jax(numbers):
    from repro.core.hardware import HardwareSpec as JaxSpec
    from repro.core.hlo_counters import Census as JaxCensus
    from repro.core.hlo_counters import CollectiveStat as JaxStat
    from repro.core.roofline import roofline_terms as jax_terms
    from repro.core.roofline import to_row as jax_row
    flops, hbm, wire = numbers
    jhw = JaxSpec(
        name=H100.name, vendor="nvidia", compute_units=132,
        schedulers_per_cu=4, ipc=1, frequency_ghz=1.98, lanes_per_issue=32,
        hbm_bw_theoretical_gbs=3352.0, peak_flops_bf16=PEAK,
        ici_links=18, ici_bw_per_link_gbs=25.0)
    jc = JaxCensus()
    jc.flops, jc.hbm_bytes = flops, hbm
    jc.collectives["all-reduce"] = JaxStat("all-reduce", 1, wire, wire)
    want = jax_terms("cell", jc, jhw, 16, model_flops_total=8 * flops)
    got = roofline_terms("cell", _census(flops, hbm, wire), H100, 16,
                         model_flops_total=8 * flops)
    assert to_row(got) == pytest.approx(jax_row(want))
    for f in ("bound_fraction", "compute_fraction", "memory_fraction",
              "collective_fraction", "achieved_tflops", "achieved_gbs"):
        assert getattr(got, f) == pytest.approx(getattr(want, f)), f
    assert got.summary() == want.summary()


def _profile(name="k", runtime_s=2.0):
    c = Census()
    c.tc_issues, c.warp_issues, c.scalar_ops = 4e9, 6e9, 1e3
    c.hbm_bytes = 2e10
    c.tc_flops, c.tc_flops_padded = 0.75 * 4e9 * 4096, 4e9 * 4096
    c.warp_flops = 1e11
    return profile_from_census(name, c, H100, runtime_s=runtime_s,
                               runtime_is_modeled=False)


def test_profile_from_census_by_hand():
    p = _profile()
    assert p.peak_tc_gips == pytest.approx(PEAK / 4096 / 1e9)
    assert p.peak_warp_gips == pytest.approx(1045.44)
    assert p.achieved_tc_gips == pytest.approx(2.0)           # 4e9 / 2 s
    assert p.achieved_warp_gips == pytest.approx(3.0)
    assert p.achieved_total_gips == pytest.approx((1e10 + 1e3) / 2e9)
    assert p.tc_intensity == pytest.approx(0.2)
    assert p.warp_intensity == pytest.approx(0.3)
    assert p.tc_padding_efficiency == pytest.approx(0.75)
    assert p.tc_utilization == pytest.approx(2.0 / (PEAK / 4096 / 1e9))
    assert p.warp_utilization == pytest.approx(3.0 / 1045.44)
    assert p.dominant_unit() == "tc"            # 0.77% against 0.29%
    row = p.table_row()
    assert row["runtime_modeled"] is False
    assert {"peak_tc_gips", "achieved_warp_gips", "tc_padding_efficiency",
            "tc_intensity_inst_per_byte", "dominant_unit"} <= set(row)


def test_step_irm_by_hand():
    model = step_irm([_profile("a"), _profile("b", 4.0)])
    gips = sorted(c.gips for c in model.ceilings if c.gips is not None)
    assert gips == pytest.approx([PEAK / 4096 / 1e9, 1045.44])
    assert [c.gbs for c in model.ceilings if c.gbs] == [3352.0]
    assert model.knee() == pytest.approx(PEAK / 4096 / 1e9 / 3352.0)
    assert [(p.label, p.series) for p in model.points] == [
        ("a (TC)", "TC"), ("a (warp)", "WARP"), ("b (TC)", "TC"),
        ("b (warp)", "WARP")]
    assert [p.gips for p in model.points] == pytest.approx([2, 3, 1, 1.5])
    assert [p.intensity for p in model.points] == pytest.approx(
        [0.2, 0.3, 0.2, 0.3])
    # the measured roof where the spec has one
    hw = h100_spec("H100", 132, 1980.0, 0, measured_gbs=2614.9)
    c = Census()
    c.tc_issues = c.hbm_bytes = 1.0
    m2 = step_irm([profile_from_census("m", c, hw, 1.0)])
    assert [x.gbs for x in m2.ceilings if x.gbs] == [2614.9]


def _log_map(v, rng, start, span, flip):
    f = (math.log10(v) - math.log10(rng[0])) / (math.log10(rng[1])
                                                 - math.log10(rng[0]))
    return start + span * (1 - f if flip else f)


def test_plot_irm_svg_coordinates(tmp_path):
    from repro_torch.core.plotting import plot_irm
    model = step_irm([_profile("a"), _profile("b", 4.0)], title="t & co")
    path = plot_irm(model, str(tmp_path / "irm.svg"))
    root = ET.parse(path).getroot()
    left, top, w, h = map(float, root.get("data-box").split())
    xr = tuple(map(float, root.get("data-x-range").split()))
    yr = tuple(map(float, root.get("data-y-range").split()))
    xs = [p.intensity for p in model.points]
    assert xr == pytest.approx((min(min(xs) / 10, model.knee() / 10),
                                max(max(xs) * 10, model.knee() * 10)))
    ys = [c.y_at(x) for c in model.ceilings for x in xr]
    ys += [p.gips for p in model.points]
    assert yr == pytest.approx((min(ys) / 2, max(ys) * 2))
    ns = "{http://www.w3.org/2000/svg}"

    def X(v):
        return _log_map(v, xr, left, w, False)

    def Y(v):
        return _log_map(v, yr, top, h, True)

    lines = [e for e in root.iter(ns + "polyline")
             if e.get("class") == "ceiling"]
    assert [e.get("data-label") for e in lines] == [
        c.label for c in model.ceilings]
    for e, c in zip(lines, model.ceilings):
        pts = [float(v) for p in e.get("points").split()
               for v in p.split(",")]
        assert pts == pytest.approx(
            [v for x in xr for v in (X(x), Y(c.y_at(x)))], abs=1e-5)
    marks = [e for e in root.iter() if e.get("class") == "point"]
    assert [e.get("data-label") for e in marks] == [
        p.label for p in model.points]
    for e, p in zip(marks, model.points):
        assert [float(e.get("data-cx")), float(e.get("data-cy"))] == \
            pytest.approx([X(p.intensity), Y(p.gips)], abs=1e-5)
    title = [e.text for e in root.iter(ns + "text")][0]
    assert title == "t & co"


def test_plot_irm_refuses_other_formats(tmp_path):
    from repro_torch.core.plotting import plot_irm
    model = step_irm([_profile()])
    with pytest.raises(ValueError, match="SVG"):
        plot_irm(model, str(tmp_path / "irm.png"))
    assert not (tmp_path / "irm.png").exists()


def test_profile_step_record():
    """``profile_step`` traces and builds the JAX record's keys; with a
    measured runtime the profile is at that time."""
    import torch

    from repro_torch.profiler.session import profile_step
    args = (torch.empty(32, 64), torch.empty(64, 16))
    rec = profile_step("mm", torch.matmul, args, 1, H100)
    assert set(rec) == {"name", "n_devices", "hw", "memory", "flop_counter",
                        "census", "roofline", "irm"}
    assert rec["flop_counter"]["flops"] == rec["census"]["tc_flops"] == \
        2 * 32 * 64 * 16
    assert rec["irm"]["runtime_modeled"] is True
    assert rec["irm"]["runtime_s"] == rec["roofline"]["modeled_time_s"]
    timed = profile_step("mm", torch.matmul, args, 1, H100, runtime_s=0.5)
    assert timed["irm"]["runtime_modeled"] is False
    assert timed["irm"]["runtime_s"] == 0.5
    assert timed["irm"]["achieved_tc_gips"] == pytest.approx(
        rec["census"]["tc_issues"] / 0.5e9)
