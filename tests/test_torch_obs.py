"""The port's metrics registry and structured logger (``repro_torch.obs``)
against the reference's ``repro.obs.metrics`` / ``repro.obs.log``.

The same sequence of registry calls gives the same Prometheus text, line
for line, and the same JSON snapshot; the log line has the same fields.
The rest are the reference's own ``tests/test_obs.py`` registry and
logger cases run on the port.
"""
import io
import json
import re
import threading

import pytest

pytest.importorskip("torch")

from repro.obs import log as rlog  # noqa: E402
from repro.obs import metrics as rmetrics  # noqa: E402
from repro_torch.obs import (MetricsRegistry, get_registry,  # noqa: E402
                             set_default_registry)
from repro_torch.obs import log as tlog  # noqa: E402
from repro_torch.obs.log import (StructLogger, effective_level,  # noqa: E402
                                 set_level)


def _drive(reg):
    """One sequence of registry calls: labelled and bare counters, a gauge,
    histograms with and without labels, escaped label values."""
    c = reg.counter("repro_p_total", "requests", labels=("tenant",))
    c.labels(tenant="a b").inc(3)
    c.labels(tenant='q"\\\n').inc()
    c.labels(tenant="a b").inc(0.25)
    reg.counter("repro_bare_total", "").inc(2)
    g = reg.gauge("repro_p_gauge", "depth")
    g.set(2.5)
    g.dec(0.5)
    h = reg.histogram("repro_p_ms", "latency")
    for v in (1.0, 2.0, 3.0, 4.0, 10.0):
        h.observe(v)
    reg.histogram("repro_empty_ms", "never observed")
    lh = reg.histogram("repro_l_ms", "per tenant", labels=("tenant", "e"),
                       cap=3)
    for i in range(7):
        lh.labels(tenant=f"t{i % 2}", e="x").observe(i * 1.5)
    return reg


@pytest.mark.parametrize("enabled", [True, False])
def test_prometheus_and_snapshot_are_the_reference(enabled):
    port = _drive(MetricsRegistry(enabled=enabled))
    ref = _drive(rmetrics.MetricsRegistry(enabled=enabled))
    assert port.prometheus().splitlines() == ref.prometheus().splitlines()
    assert port.snapshot() == ref.snapshot()
    assert port.to_json() == ref.to_json()
    assert port.names() == ref.names()


@pytest.mark.parametrize("level,fields", [
    ("error", dict(n=3, ms=1.23456789, msg="a b", eq="k=v")),
    ("warning", dict(empty="", path="/tmp/x", flag=True, q='say "hi"')),
    ("info", dict()),
])
def test_log_line_is_the_reference(level, fields):
    lines = []
    for mod in (tlog, rlog):
        buf = io.StringIO()
        mod.set_level("debug")
        try:
            mod.StructLogger("autotune", stream=buf).log(level, "sweep",
                                                         **fields)
        finally:
            mod.set_level(None)
        # drop the timestamp, the one field that differs between calls
        lines.append(buf.getvalue().split(" ", 1)[1])
    assert lines[0] == lines[1]


def test_log_level_resolution_is_the_reference(monkeypatch):
    for env in ("", "error", "debug", "loud"):
        monkeypatch.setenv("REPRO_LOG_LEVEL", env)
        assert tlog.effective_level() == rlog.effective_level()
    assert tlog.LEVELS == rlog.LEVELS


# --------------------------------------------------------------------------- #
# the reference's own cases (tests/test_obs.py), on the port
# --------------------------------------------------------------------------- #
def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("repro_t_total", "h")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1.0)
    g = reg.gauge("repro_t_gauge", "h")
    g.set(7.0)
    g.dec(2.0)
    assert g.value == 5.0
    h = reg.histogram("repro_t_ms", "h")
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100
    assert h.sum == sum(range(100))
    assert h.percentile(50) == pytest.approx(49.5)


def test_labels_exact_schema_and_children():
    reg = MetricsRegistry()
    c = reg.counter("repro_l_total", "h", labels=("tenant",))
    c.labels(tenant="a").inc()
    c.labels(tenant="a").inc()
    c.labels(tenant="b").inc()
    assert c.labels(tenant="a").value == 2
    assert c.labels(tenant="b").value == 1
    for bad in (lambda: c.labels(wrong="a"), lambda: c.labels(),
                lambda: c.inc()):
        with pytest.raises(ValueError):
            bad()


def test_get_or_create_rejects_kind_and_schema_mismatch():
    reg = MetricsRegistry()
    reg.counter("repro_m_total", "h", labels=("tenant",))
    again = reg.counter("repro_m_total", "h", labels=("tenant",))
    assert again is reg.get("repro_m_total")
    with pytest.raises(ValueError):
        reg.gauge("repro_m_total", "h")
    with pytest.raises(ValueError):
        reg.counter("repro_m_total", "h", labels=("x",))


@pytest.mark.parametrize("name,labels", [("0bad", ()), ("bad-name", ()),
                                         ("ok_total", ("bad-label",))])
def test_metric_name_validation(name, labels):
    with pytest.raises(ValueError):
        MetricsRegistry().counter(name, "h", labels=labels)


def test_disabled_registry_is_noop():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("repro_d_total", "h")
    c.inc(5)
    h = reg.histogram("repro_d_ms", "h")
    h.observe(1.0)
    assert c.value == 0.0
    assert h.count == 0
    reg.enable(True)
    c.inc(5)
    assert c.value == 5.0


def test_default_registry_swap_restores():
    mine = MetricsRegistry()
    old = set_default_registry(mine)
    try:
        assert get_registry() is mine
    finally:
        set_default_registry(old)
    assert get_registry() is old


def test_prometheus_text_line_by_line():
    lines = _drive(MetricsRegistry()).prometheus().splitlines()
    assert "# HELP repro_p_total requests" in lines
    assert "# TYPE repro_p_total counter" in lines
    assert "# TYPE repro_p_gauge gauge" in lines
    assert "# TYPE repro_p_ms summary" in lines
    assert 'repro_p_total{tenant="a b"} 3.25' in lines
    assert 'repro_p_total{tenant="q\\"\\\\\\n"} 1' in lines
    assert "repro_p_gauge 2" in lines
    assert 'repro_p_ms{quantile="0.5"} 3' in lines
    assert "repro_p_ms_sum 20" in lines
    assert "repro_p_ms_count 5" in lines
    sample_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.einfa+-]+$')
    for ln in lines:
        if ln and not ln.startswith("#"):
            assert sample_re.match(ln), ln


def test_json_snapshot_round_trip():
    reg = MetricsRegistry()
    reg.counter("repro_j_total", "h", labels=("tenant",)) \
       .labels(tenant="x").inc(2)
    reg.histogram("repro_j_ms", "h").observe(4.0)
    snap = reg.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert snap["repro_j_total"]["type"] == "counter"
    (sample,) = snap["repro_j_total"]["samples"]
    assert sample["labels"] == {"tenant": "x"} and sample["value"] == 2
    (hs,) = snap["repro_j_ms"]["samples"]
    assert hs["count"] == 1 and hs["sum"] == 4.0


def test_thread_hammer_exact_totals_under_concurrent_scrapes():
    reg = MetricsRegistry()
    c = reg.counter("repro_h_total", "h", labels=("tenant",))
    h = reg.histogram("repro_h_ms", "h", labels=("tenant",))
    N_THREADS, N_OPS = 8, 500
    stop = threading.Event()
    scrapes = []

    def mutate(tid):
        child_c = c.labels(tenant=f"t{tid % 2}")
        child_h = h.labels(tenant=f"t{tid % 2}")
        for i in range(N_OPS):
            child_c.inc()
            child_h.observe(float(i))

    def scrape():
        # a pause between scrapes: a scraper that retakes the lock at once
        # can starve the writers on a loaded host
        while not stop.wait(0.001):
            scrapes.append(reg.prometheus())
            reg.snapshot()

    scraper = threading.Thread(target=scrape)
    scraper.start()
    threads = [threading.Thread(target=mutate, args=(i,))
               for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    scraper.join(timeout=60)
    assert not scraper.is_alive()
    assert not any(t.is_alive() for t in threads)
    assert sum(c.labels(tenant=t).value for t in ("t0", "t1")) == \
        N_THREADS * N_OPS
    assert sum(h.labels(tenant=t).count for t in ("t0", "t1")) == \
        N_THREADS * N_OPS
    assert scrapes


def test_logger_line_format_and_quoting():
    buf = io.StringIO()
    StructLogger("testcomp", stream=buf).error(
        "an_event", n=3, ms=1.23456789, msg="a b", eq="k=v")
    line = buf.getvalue().strip()
    parts = line.split(" ", 3)
    assert parts[1] == "ERROR" and parts[2] == "testcomp"
    assert "an_event" in parts[3]
    assert "n=3" in line
    assert "ms=1.23457" in line
    assert "msg='a b'" in line
    assert "eq='k=v'" in line


def test_logger_quiet_under_pytest_and_forced_level(monkeypatch):
    monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
    assert effective_level() == "warning"
    buf = io.StringIO()
    lg = StructLogger("t", stream=buf)
    lg.info("hidden")
    assert buf.getvalue() == ""
    lg.warning("shown")
    assert "shown" in buf.getvalue()
    set_level("debug")
    try:
        lg.debug("now_visible")
        assert "now_visible" in buf.getvalue()
    finally:
        set_level(None)
    with pytest.raises(ValueError):
        set_level("loud")


def test_logger_env_level(monkeypatch):
    monkeypatch.setenv("REPRO_LOG_LEVEL", "error")
    buf = io.StringIO()
    lg = StructLogger("t", stream=buf)
    lg.warning("hidden")
    assert buf.getvalue() == ""
    lg.error("shown")
    assert "shown" in buf.getvalue()
