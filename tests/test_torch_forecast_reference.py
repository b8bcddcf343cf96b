"""The graph-conv LSTM forecaster (``GConvForecaster`` variant
``glstm_period_expand_gconv3``) against the benchmark's plain float64
reference, ``benchmark/reference/forecaster.py``, which imports nothing
of the port: on seeded random weights at a small size (``city`` side 8,
64 nodes; B 4, H 8, K 2, Tc 3 / Tp 2 / Tt 2, 2 gLSTM layers, 2 residual
blocks), on the banded operator (K1's plain version) and the dense one.

* the forward, and one ``Trainer._train_step``'s gradients (read from
  Adam's first moment) with the dropout masks the reference replays from
  a generator seeded as the Trainer's;
* the tolerance is tight: the reference with TF32-rounded tap operands,
  or with the fork's ``tf.tan`` gate z, falls outside it;
* under ``recording()`` one forward records ``glstm.gates`` once a cell
  step (layers x (Tc + Tp + Tt)) and ``glstm_gate_bytes`` = 44 H B M a
  gates span.

The reference is loaded by its file path (``importlib.util``), so that
the benchmark's ``models`` and ``harness`` packages shadow nothing here.
Tolerances: outputs within 1e-5 of their largest magnitude (f32 against
float64 reads about 2e-7; the TF32 control about 6e-4); gradients within
1e-4 of each leaf's largest entry.  No JAX."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cnn_graph_tpu_torch.graphs import construction
from cnn_graph_tpu_torch.models import GConvForecaster
from cnn_graph_tpu_torch.models.common import tree_leaves, tree_map
from cnn_graph_tpu_torch.ops import device_laplacian
from cnn_graph_tpu_torch.train import TrainConfig, Trainer
from cnn_graph_tpu_torch.utils import profiling

REF_PATH = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
            / "reference" / "forecaster.py")
B, H, TC, TP, TT, LAYERS, KEEP, SEED = 4, 8, 3, 2, 2, 2, 0.8, 2_700_000_123
WINDOWS = [(TC, 0, 2 * TC), (TP, 2 * TC, 2 * (TC + TP)),
           (TT, 2 * (TC + TP), 2 * (TC + TP + TT))]
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
OPERATORS = {"banded": dict(fmt="banded", use_pallas=True),
             "dense": dict(fmt="dense")}


def _load_reference():
    spec = importlib.util.spec_from_file_location("forecaster_reference",
                                                  REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load_reference()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Tiny products run faster on few threads than on every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    L, _ = construction.city_graph(8, k=8, seed=0)
    rng = np.random.default_rng(SEED)
    x = rng.random((B, L.shape[0], 2 * (TC + TP + TT))).astype(np.float32)
    y = rng.random((B, L.shape[0], 2)).astype(np.float32)
    return L, torch.from_numpy(x), torch.from_numpy(y)


def _model(L, operator):
    op = device_laplacian(L, device="cpu", **OPERATORS[operator])
    model = GConvForecaster(
        op, TC, TP, TT, variant="glstm_period_expand_gconv3", num_hidden=H,
        conv_layer_num=2, lstm_layer_count=LAYERS, K=2,
        lstm_keep_prob=KEEP, generator=torch.Generator().manual_seed(SEED))
    # Five times the initializers' scale: the gates leave their linear
    # range, so that a wrong gate shows.
    params = tree_map(lambda t: 5.0 * t.detach(), model.param_tree())
    return model, params


def _gap(out, want) -> float:
    out = out.detach().to(torch.float64)
    want = want.detach()
    return float((out - want).abs().max() / want.abs().max())


def _reference_out(ref, L, params, x, **kw):
    p64 = tree_map(lambda t: t.to(torch.float64), params)
    return ref.forward(ref.operator(L, "cpu"), p64, x.double(), WINDOWS,
                       **kw)


@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_forward_matches_the_reference(ref, problem, operator):
    L, x, _ = problem
    model, params = _model(L, operator)
    with torch.no_grad():
        out = model.apply(params, x)
    assert _gap(out, _reference_out(ref, L, params, x)) <= OUT_TOL


@pytest.mark.parametrize("control", [{"precision": "tf32"},
                                     {"gate_z": "tan"}],
                         ids=["tf32_taps", "fork_tan_gate"])
def test_the_tolerance_is_tight(ref, problem, control):
    """The reference one step off (TF32 taps, the fork's gate z) is
    caught by the tolerance that the program passes."""
    L, x, _ = problem
    _, params = _model(L, "dense")
    want = _reference_out(ref, L, params, x)
    assert _gap(_reference_out(ref, L, params, x, **control), want) > (
        10 * OUT_TOL)


@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_train_step_gradients_match_the_reference(ref, problem, operator):
    """One ``Trainer._train_step`` (dropout on): its gradients, read from
    Adam's first moment, against the reference's with the masks drawn in
    the program's order from a generator seeded as the Trainer's."""
    L, x, y = problem
    model, params = _model(L, operator)
    # The step updates params in place: the reference takes them before.
    named = ref.named_leaves(tree_map(
        lambda t: t.detach().double().requires_grad_(), params))
    trainer = Trainer(model, TrainConfig(learning_rate=1e-3, batch_size=B,
                                         seed=SEED), task="regression")
    opt_state = trainer.optimizer.init(tree_leaves(params))
    gen = torch.Generator().manual_seed(SEED)
    opt_state, _ = trainer._train_step(params, opt_state,
                                       torch.tensor(-1.0), gen, x, y)
    grads = [mu.double() / (1 - 0.9) for mu in opt_state["mu"]]

    tree = ref.rebuild(params, dict(named))
    masks = ref.dropout_masks(torch.Generator().manual_seed(SEED), B,
                              L.shape[0], H, WINDOWS, LAYERS, KEEP)
    loss = ref.loss(ref.operator(L, "cpu"), tree, x.double(), y.double(),
                    WINDOWS, keep=KEEP, masks=masks)
    want = torch.autograd.grad(loss, [t for _, t in named])
    assert len(want) == len(grads)
    for (name, _), g, w in zip(named, grads, want):
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, name


def test_forward_records_gates_spans_and_bytes(problem):
    L, x, _ = problem
    model, params = _model(L, "banded")
    with torch.no_grad(), profiling.recording() as rec:
        model.apply(params, x)
    names = [s.name for s in rec.spans]
    steps = LAYERS * (TC + TP + TT)
    assert names.count("glstm.step") == steps
    assert names.count("glstm.gates") == steps
    assert names.count("forecast.branch") == 3
    assert names.count("forecast.stack") == 1
    gates = [s for s in rec.spans if s.name == "glstm.gates"]
    assert all(rec.spans[s.parent].name == "glstm.step" for s in gates)
    assert sum(rec.per_unit["glstm_gate_bytes"].values()) == (
        44 * H * B * L.shape[0] * steps)
