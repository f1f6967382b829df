"""The readers of the program's spans: a traced run of the tiny cell on the
CPU reports a number for each, and a program without the spans reads as
absent, not as zero."""

from benchmark import run

from helpers import quiet, tiny_root

SPAN_METRICS = ("orient_share", "pileup_walk_share", "walk_us_per_read",
                "polish_files_share", "moves_host_share", "stats_host_share",
                "cluster_build_share")


def test_a_traced_run_reports_every_span_metric(tmp_path):
    root = tiny_root(tmp_path)
    result = run.run_cell("tiny.medaka", 2**31 + 21, 0.1, True, root=root,
                          backend="torch", require_chip=False, log=quiet)
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    for name in SPAN_METRICS:
        assert name in metrics, name
        assert metrics[name]["value"] > 0, name
    for name in SPAN_METRICS:
        if name.endswith("_share"):
            assert metrics[name]["value"] < 100, name
    assert metrics["walk_us_per_read"]["unit"] == "us"


def test_without_the_spans_every_reader_finds_nothing():
    bench = run.Bench()
    older = {"sort": 0.1, "cluster": 0.4, "consensus_polish": 0.5,
             "stage4_polish": 0.3}
    rec = run.Records("coi_plate.medaka", 1.0, 2.0,
                      [run.Lib(0, 120, "", "", None, walls=older)], [], {})
    for name in SPAN_METRICS:
        assert bench.reader(name)(rec) is None, name
