"""The port's last utilities against the JAX package's: ``StepTimer`` and
``trace`` (``utils/profiling.py``), ``ModelPerf``, ``grid_search`` and
``baseline`` (``utils/harness.py``) on the same trainer results and
arrays, ``send_notification``'s file sink byte for byte, and
``plot_spectrum``'s data; and the ``usage_demo`` and ``gconv_sweep``
drivers as subprocesses on the CPU at tiny sizes."""

import contextlib
import io
import json
import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from cnn_graph_tpu.graphs import construction as gc  # noqa: E402
from cnn_graph_tpu.utils import harness as jax_harness  # noqa: E402
from cnn_graph_tpu.utils import notify as jax_notify  # noqa: E402
from cnn_graph_tpu.utils import plots as jax_plots  # noqa: E402
from cnn_graph_tpu_torch.utils import StepTimer, trace  # noqa: E402
from cnn_graph_tpu_torch.utils import harness, notify, plots  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


class TestProfiling:
    def test_step_timer(self):
        timer = StepTimer()
        assert timer.mean_ms == 0.0 and timer.min_ms == 0.0
        for n in (64, 128):
            timer.start()
            y = torch.ones(n, n) @ torch.ones(n, n)
            timer.stop({"y": [y]})
        timer.start()
        timer.stop()
        assert len(timer.times) == 3 and all(t >= 0 for t in timer.times)
        assert timer.min_ms <= timer.mean_ms
        np.testing.assert_allclose(timer.mean_ms,
                                   1e3 * sum(timer.times) / 3)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(str(tmp_path / "tr")) as prof:
            torch.ones(32, 32).sum()
        assert prof is not None
        with open(tmp_path / "tr" / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::" in str(e.get("name", "")) for e in events)


class _Trainer:
    """A trainer with fixed fit and evaluation results, for both
    packages' harnesses."""

    def __init__(self, scale=1.0, fail=False):
        self.scale, self.fail = scale, fail

    def fit(self, *data):
        if self.fail:
            raise ValueError("diverged")
        return [0.5, 0.7 * self.scale], [1.2, 0.9 * self.scale], 0.0123

    def evaluate(self, data, labels):
        main = 80.0 * self.scale + len(data)
        return (f"accuracy: {main:.2f}",
                {"main": main, "loss": 0.25 / self.scale,
                 "predictions": np.arange(len(data))})


class TestHarness:
    data = [np.zeros((n, 2)) for n in (6, 3, 4)]
    labels = [np.zeros(n) for n in (6, 3, 4)]

    def _split(self):
        return (self.data[0], self.labels[0], self.data[1], self.labels[1],
                self.data[2], self.labels[2])

    def test_model_perf_table_matches_jax(self):
        prints = []
        for mod in (harness, jax_harness):
            perf = mod.ModelPerf()

            def run(perf=perf):
                for name, s in (("b_model", 1.0), ("a_model", 0.5)):
                    perf.test(_Trainer(s), name, {"s": s}, *self._split())
                perf.show()
                return perf

            perf, text = _stdout(run)
            prints.append(text)
            assert perf.names == ["b_model", "a_model"]
            assert perf.fit_time["a_model"] == 0.0123
        assert prints[0] == prints[1]
        assert "84.00 86.00" in prints[0] and "a_model" in prints[0]

    def test_model_perf_plot(self):
        perf = harness.ModelPerf()
        _stdout(perf.test, _Trainer(), "m", {}, *self._split())
        fig = perf.plot(eval_frequency=10)
        xs = fig.axes[0].lines[0].get_xdata()
        np.testing.assert_array_equal(xs, [10, 20])

    def test_grid_search_matches_jax(self):
        def make(scale, fail):
            return _Trainer(scale, fail)

        grid = {"scale": [1.0, 2.0], "fail": [False, True]}
        outs = [_stdout(mod.grid_search, grid, make, *self._split())
                for mod in (harness, jax_harness)]
        (res, text), (res_j, text_j) = outs
        assert text == text_j and "FAILED: ValueError: diverged" in text
        assert [c for c, _ in res] == [c for c, _ in res_j]
        assert [None if m is None else m["main"] for _, m in res] == [
            None if m is None else m["main"] for _, m in res_j]

    def test_baseline_matches_jax(self):
        rng = np.random.default_rng(0)
        X = np.abs(rng.normal(size=(120, 10)))
        y = (X[:, 0] + 0.3 * rng.normal(size=120) > 0.8).astype(int)
        rows = []
        for mod in (harness, jax_harness):
            np.random.seed(0)  # the forest and the SVC draw from it
            out, _ = _stdout(mod.baseline, X[:80], y[:80], X[80:], y[80:])
            rows.append(out)
        assert [r["name"] for r in rows[0]] == [r["name"] for r in rows[1]]
        assert len(rows[0]) == 7
        for a, b in zip(*rows):
            for k in ("train_accuracy", "test_accuracy", "train_f1",
                      "test_f1"):
                assert a[k] == b[k], (a["name"], k)
        out, _ = _stdout(harness.baseline, X[:80], y[:80], X[80:], y[80:],
                         omit=(3, 6))
        assert [r["name"] for r in out] == [
            r["name"] for i, r in enumerate(rows[1]) if i not in (3, 6)]

    def test_baseline_names_scikit_learn_where_absent(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "sklearn", None)
        with pytest.raises(ImportError, match="scikit-learn"):
            harness.baseline(np.zeros((4, 2)), np.zeros(4), np.zeros((2, 2)),
                             np.zeros(2))


class TestNotify:
    def test_file_sink_matches_jax_byte_for_byte(self, tmp_path, monkeypatch):
        for mod in (notify, jax_notify):
            monkeypatch.setattr(mod.time, "strftime",
                                lambda fmt: "2026-01-02 03:04:05")
        paths = [tmp_path / "port.jsonl", tmp_path / "jax.jsonl"]
        for mod, path in zip((notify, jax_notify), paths):
            for msg, kw in (("sweep done", {"rmse": 1.5}),
                            ("second", {"trial": 3, "tag": "a b"})):
                assert mod.send_notification(msg, sink=f"file:{path}", **kw)
        assert paths[0].read_bytes() == paths[1].read_bytes()
        lines = paths[0].read_text().splitlines()
        assert json.loads(lines[0])["rmse"] == 1.5 and len(lines) == 2

    def test_print_sink_and_a_failing_sink(self, tmp_path, monkeypatch):
        monkeypatch.delenv("CNN_GRAPH_NOTIFY", raising=False)
        ok, text = _stdout(notify.send_notification, "hello", k=1)
        assert ok and text.startswith("[notify] ") and "'hello'" in text
        bad = f"file:{tmp_path / 'missing' / 'dir' / 'n.jsonl'}"
        assert notify.send_notification("x", sink=bad) is False
        monkeypatch.setenv("CNN_GRAPH_NOTIFY", f"file:{tmp_path / 'e.jsonl'}")
        assert notify.send_notification("from env")
        assert "from env" in (tmp_path / "e.jsonl").read_text()


def test_plot_spectrum_data_matches_jax():
    z = np.random.default_rng(3).normal(size=(40, 3)).astype(np.float32)
    L0 = gc.laplacian(gc.knn_graph(z, k=5), normalized=True)
    L1 = gc.laplacian(gc.knn_graph(z[:20], k=4), normalized=True)
    laps = [L0, L1]
    fig, fig_j = plots.plot_spectrum(laps), jax_plots.plot_spectrum(laps)
    lines, lines_j = fig.axes[0].lines, fig_j.axes[0].lines
    assert len(lines) == len(lines_j) == 2
    for a, b in zip(lines, lines_j):
        np.testing.assert_array_equal(a.get_xdata(), b.get_xdata())
        np.testing.assert_allclose(a.get_ydata(), b.get_ydata(), atol=1e-10)
        assert a.get_label() == b.get_label()
    assert fig.axes[0].get_xlim() == fig_j.axes[0].get_xlim()
    data = plots.spectrum_lines(laps)
    assert list(data[1][0]) == list(range(1, 40, 2))


@pytest.mark.parametrize("module,args,want", [
    ("usage_demo", ["--n", "400", "--d", "20", "--epochs", "1",
                    "--batch-size", "50"], "cgconv_softmax"),
    ("gconv_sweep", ["--nodes", "12", "--epochs", "1", "--trials-limit",
                     "2"], "=== ranking (by RMSE) ==="),
])
def test_driver_runs_on_the_cpu(module, args, want):
    proc = subprocess.run(
        [sys.executable, "-m", f"cnn_graph_tpu_torch.experiments.{module}",
         "--device", "cpu", *args], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert want in proc.stdout, proc.stdout[-2000:]
    if module == "gconv_sweep":
        ranked = [s for s in proc.stdout.splitlines() if s.startswith("RMSE")]
        assert len(ranked) == 2 and "inf" not in "".join(ranked)
