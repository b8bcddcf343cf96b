"""The port's node-classification driver
(``cnn_graph_tpu_torch/experiments/node_classification.py``) as a user
runs it, on the CPU: training, the int8 report and the serving artifact
it writes, which then loads and serves; its refusals of the sharded
options; and the banded plain version traced by ``torch.export`` with
the operator's tables as inputs (the trace that once stopped on a
data-dependent guard in ``ops/band.py _windows_reference``)."""

import copy
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.experiments import node_classification as driver
from cnn_graph_tpu_torch.ops import cheby_conv, device_laplacian
from cnn_graph_tpu_torch.serve import load_serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, CLASSES, FEATURES = 1024, 16, 32


def test_driver_trains_reports_and_exports(tmp_path):
    d = str(tmp_path / "artifact")
    proc = subprocess.run(
        [sys.executable, "-m",
         "cnn_graph_tpu_torch.experiments.node_classification",
         "--device", "cpu", "--nodes", str(NODES), "--steps", "20",
         "--int8", "--export", d],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert re.search(rf"graph: {NODES} nodes, \d+ nnz", out), out
    acc = re.search(r"train acc ([\d.]+) \| test acc ([\d.]+)", out)
    int8 = re.search(r"int8 test acc ([\d.]+) \(delta vs f32 ([-+][\d.]+)\)",
                     out)
    assert acc and int8, out
    # 16 classes: chance is 1/16.
    assert float(acc.group(2)) > 4.0 / CLASSES
    assert abs(float(int8.group(2))) < 0.05
    for name in ("f32 ", "int8"):
        assert re.search(rf"{name} inference +[\d.]+ ms/graph +[\d.]+ "
                         r"Gedges/s \(4 spmm/inference\) \[cpu\]", out), out
    assert f"serving artifact written to {d} (int8=True)" in out

    # The artifact on the driver's own data: the int8 test accuracy it
    # printed, from the directory alone.
    served = load_serving(d)
    assert served.meta["int8"] is True
    L, feats, labels = driver.build_graph(NODES, CLASSES, FEATURES, 0)
    fp, yp, _, test = driver.node_data(feats, labels,
                                       served.input_spec.shape[0], 0.1, 0)
    logits = served(torch.from_numpy(fp))
    assert tuple(logits.shape) == (fp.shape[0], CLASSES)
    hits = (logits.argmax(1).numpy() == yp)[test]
    assert f"{hits.mean():.4f}" == int8.group(1)


@pytest.mark.parametrize("flags", [["--mesh-nodes", "4", "--halo", "sparse"],
                                   ["--mesh-nodes", "2", "--halo",
                                    "sparse-banded"]])
def test_sharded_options_raise(flags):
    """The sharded options run one process per rank: launched alone,
    with no rendezvous to join, the driver refuses before any work.
    Under ``torch.distributed.run`` both sparse halo formats run
    (tests/test_torch_sparse_halo.py), and the banded halo
    (tests/test_torch_parallel.py)."""
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        driver.main(["--device", "cpu", "--nodes", "64", *flags])


def test_parsed_defaults_match_jax():
    """The port's driver parses the JAX driver's defaults (``--halo``
    banded among them), read from its ``add_argument`` calls without
    running it; the port adds ``--device``."""
    import ast

    path = os.path.join(ROOT, "experiments", "node_classification.py")
    jax_defaults = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            if "default" not in kw:  # a flag: store_true's default
                assert ast.literal_eval(kw["action"]) == "store_true"
            jax_defaults[dest] = (ast.literal_eval(kw["default"])
                                  if "default" in kw else False)
    ours = vars(driver.parser().parse_args([]))
    assert ours.pop("device") is None
    assert ours == jax_defaults
    assert ours["halo"] == "banded"


class _BandedConv(torch.nn.Module):
    """``cheby_conv`` on a copy of ``op`` whose tensor fields are the
    module's inputs."""

    def __init__(self, op, names):
        super().__init__()
        self._op = (op, names)

    def forward(self, tables, x, w):
        op, names = self._op
        traced = copy.copy(op)
        for name, t in zip(names, tables):
            object.__setattr__(traced, name, t)
        return cheby_conv(x, traced, w)


def test_banded_plain_version_exports():
    """The flat ragged operator's plain version (``use_pallas=False``,
    the CPU's default) traced with every tensor field as an input: its
    row lists per level are shapes, so the trace never sizes a tensor by
    ``sched``'s values, and the program computes what the eager conv
    does."""
    L, _ = graphs.city_graph(16, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", use_pallas=False, device="cpu")
    assert op.levels and op.bands_dkw is None and not op.use_pallas
    names = [f.name for f in dataclasses.fields(op)
             if isinstance(getattr(op, f.name), torch.Tensor)]
    assert "sched" in names and "band" in names
    tables = [getattr(op, n) for n in names]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, op.m, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 4, 5)).astype(np.float32))
    module = _BandedConv(op, names)
    with torch.no_grad():
        program = torch.export.export(module, (tables, x, w), strict=False)
        want = cheby_conv(x, op, w)
    assert torch.equal(program.module()(tables, x, w), want)
