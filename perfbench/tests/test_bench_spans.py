"""``program_spans.py`` and the five metrics that read the program's
``mcrt.*`` spans, on records built by hand, and once on a traced CPU run of
a cell."""
import pytest

from perfbench import manifest, program_spans
from perfbench.trace import WINDOW_SPAN, Record

METRICS = ("shade.ops_per_spp", "queries.ops_per_spp", "shade.idle_share",
           "queries.idle_share", "device.idle_share.unspanned")


def _record(host, device, loop="progressive", samples=1, untraced_s=2e-3):
    """A window of 0-1000 us."""
    return Record(loop=loop, samples=samples, device=list(device),
                  host=[(WINDOW_SPAN, 0.0, 1000.0)] + list(host), window=(0.0, 1000.0),
                  untraced_s=untraced_s)


def _read(metric, rec):
    return manifest.reader(metric)(rec)


def test_an_op_nested_in_another_op_is_not_counted():
    host = [("mcrt.frame", 10.0, 900.0), ("mcrt.shade", 100.0, 200.0),
            ("aten::where", 110.0, 20.0), ("aten::empty", 112.0, 2.0),  # inside where
            ("aten::mul", 140.0, 10.0), ("aten::copy_", 140.0, 10.0),  # same span
            ("perfbench.query.intersect", 400.0, 50.0),
            ("mcrt.query.closest", 401.0, 48.0), ("aten::sort", 402.0, 5.0),
            ("aten::add", 500.0, 5.0)]  # in the frame, outside both stages
    rec = _record(host, [("k", 0.0, 1000.0)], samples=2)
    assert program_spans.top_level_ops(rec.host) == [110.0, 140.0, 402.0, 500.0]
    assert _read("shade.ops_per_spp", rec) == 1.0
    assert _read("queries.ops_per_spp", rec) == 0.5


def test_a_gap_goes_to_the_innermost_span_at_its_start():
    """However many host events lie between the outer span's start and the
    gap, the gap is the innermost span's."""
    ops = [("aten::mul", 20.0 + i, 0.5) for i in range(300)]
    host = [("mcrt.frame", 10.0, 980.0), ("mcrt.shade", 15.0, 600.0),
            ("mcrt.shade.nee", 400.0, 100.0)] + ops
    device = [("k", 0.0, 450.0), ("k", 460.0, 540.0)]  # idle 450-460, in nee
    rec = _record(host, device)
    assert program_spans.idle_by_span(rec, program_spans.Spans(rec.host)) == {
        "mcrt.shade.nee": 10.0}
    spans = program_spans.Spans(host)
    assert spans.at(450.0) == "mcrt.shade.nee"
    assert spans.at(600.0) == "mcrt.shade"
    assert spans.at(700.0) == "mcrt.frame"
    assert spans.at(5.0) is None and spans.at(990.0) is None


def test_a_gap_in_no_span_is_unspanned():
    host = [("mcrt.frame", 100.0, 500.0), ("mcrt.shade", 150.0, 100.0)]
    device = [("k", 0.0, 50.0), ("k", 80.0, 120.0), ("k", 250.0, 750.0)]
    rec = _record(host, device)
    # gaps: 50-80 before the frame, 200-250 in the shade span
    by = program_spans.idle_by_span(rec, program_spans.Spans(rec.host))
    assert by == {program_spans.UNSPANNED: 30.0, "mcrt.shade": 50.0}
    render = _read("device.idle_share.render", rec)
    assert _read("device.idle_share.unspanned", rec) == pytest.approx(render * 30 / 80)
    assert _read("shade.idle_share", rec) == pytest.approx(render * 50 / 80)
    assert _read("queries.idle_share", rec) == 0.0


@pytest.mark.parametrize("loop", ["progressive", "sharded"])
def test_the_stage_shares_sum_to_the_render_share(loop):
    host = [("mcrt.dist.local", 5.0, 990.0), ("mcrt.frame", 10.0, 980.0),
            ("mcrt.camera", 20.0, 60.0),
            ("mcrt.query.closest", 100.0, 100.0), ("mcrt.query.sort", 110.0, 20.0),
            ("mcrt.shade", 220.0, 300.0), ("mcrt.shade.interaction", 230.0, 50.0),
            ("mcrt.shade.bsdf", 400.0, 80.0),
            ("mcrt.query.occluded", 600.0, 100.0), ("mcrt.film", 800.0, 50.0),
            ("mcrt.dist.all_reduce", 900.0, 40.0)]
    device = [(f"k{i}", float(s), 7.0) for i, s in enumerate(range(0, 1000, 13))]
    rec = _record(host, device, loop=loop)
    render = _read("device.idle_share.render", rec)
    spans = program_spans.Spans(rec.host)
    by = program_spans.idle_by_span(rec, spans)
    total = sum(by.values())
    rest = sum(v for k, v in by.items() if not program_spans.in_stage(k, "mcrt.shade")
               and not program_spans.in_stage(k, "mcrt.query")
               and k != program_spans.UNSPANNED)
    assert {"mcrt.camera", "mcrt.film", "mcrt.frame", "mcrt.shade.bsdf",
            "mcrt.query.sort", "mcrt.dist.all_reduce"} <= set(by)
    shares = [_read(m, rec) for m in ("shade.idle_share", "queries.idle_share",
                                      "device.idle_share.unspanned")]
    assert all(s > 0 for s in shares)
    assert sum(shares) + render * rest / total == pytest.approx(render, abs=1e-9)


@pytest.mark.parametrize("metric", METRICS)
def test_readers_find_nothing_without_program_spans_or_in_the_grad_loop(metric):
    host = [("perfbench.query.intersect", 100.0, 50.0), ("aten::mul", 110.0, 5.0)]
    device = [("k", 0.0, 500.0)]
    assert _read(metric, _record(host, device)) is None  # the parent's record
    spanned = host + [("mcrt.loss", 50.0, 800.0), ("mcrt.shade", 100.0, 100.0)]
    assert _read(metric, _record(spanned, device, loop="grad")) is None
    assert _read(metric, _record(spanned, device)) is not None


def test_a_traced_cpu_run_reports_the_five_metrics():
    from perfbench.run import run_cell

    r = run_cell("textured_hall.pt", 2**31 + 23, 0.5, True, device="cpu",
                 overrides={"render": {"width": 8, "height": 8},
                            "traffic": {"check_pixels": 16}})
    assert r["correct"]
    got = r["metrics"]
    assert set(METRICS) <= set(got)
    assert got["shade.ops_per_spp"]["value"] > got["queries.ops_per_spp"]["value"] > 0
    assert all(got[m]["unit"] == "%" and 0 <= got[m]["value"] <= 100
               for m in ("shade.idle_share", "queries.idle_share",
                         "device.idle_share.unspanned"))
