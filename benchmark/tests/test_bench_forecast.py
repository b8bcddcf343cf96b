"""The two cells of the forecaster's PR on the CPU at a tiny size, with
their own overrides: ``gconvlstm-cpt-city8k-train-f32`` (a sound run is
``correct``; a step that leaves its state unchanged and a step on half
of each batch are each caught; its controls fail the tiny limits) and
``nodecls-city50k-serve-bf16`` (a sound run is ``correct``, an altered
answer and the int8-carries control are caught).  Also the frozen copies
of ``datasets/synthetic_flow.py`` against the program's flows and
windows, and the forecaster's work rule against a hand count."""

import time

import numpy as np
import pytest
import torch

import control

FC = "gconvlstm-cpt-city8k-train-f32"
BF = "nodecls-city50k-serve-bf16"
_FC_CONFIG = {"graph": {"kind": "city", "side": 6, "k": 8, "seed": 0,
                        "jitter": 0.3},
              "num_hidden": 8, "batch_size": 4, "seq_closeness": 3,
              "seq_period": 2, "seq_trend": 2, "conv_layer_num": 2,
              "operator_format": "banded"}
_CITY = {"graph": {"kind": "city", "side": 16, "k": 8, "seed": 0,
                   "jitter": 0.3},
         "K": 5, "input_features": 32, "hidden": [32], "num_classes": 4,
         "operator_format": "banded"}
# At 36 nodes and H 8 a sound run reads about 5e-8 (loss), 1.2e-7
# (gradients) and 7e-6 (changes); TF32 taps 3e-7, 5e-4 and 8e-4.  The
# bf16 serving cell's sound tiny run reads under 1e-3 (conftest's
# ``nodecls-serve-bf16``).
TINY = {
    FC: {"config": _FC_CONFIG,
         "traffic": {"eval_frequency": 20, "reference_chunk": 3},
         "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                    "change_gap": 2e-4},
         "sound": {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-4}},
    BF: {"config": _CITY, "limits": {"logit_gap": 0.01},
         "sound": {"logit_gap": 1e-3}},
}


@pytest.fixture(autouse=True)
def few_threads():
    """Tiny products run faster on few threads than on every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(manifest, name, seed=2_700_000_123):
    from harness.runner import run_cell

    return run_cell(manifest, name, seed, 0.3, False, torch.device("cpu"),
                    time.perf_counter(), overrides=TINY[name],
                    log=lambda s: None)


@pytest.mark.parametrize("name", [FC, BF])
def test_sound_run_is_correct(manifest, name):
    r = _run(manifest, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for k, c in r["checks"].items():
        assert c["value"] < TINY[name]["sound"][k], (k, c)


def _unchanged_state(monkeypatch):
    from cnn_graph_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_train_step",
                        lambda self, p, s, ema, *a: (s, ema))


def _half_batch(monkeypatch):
    from cnn_graph_tpu_torch.models import GConvForecaster

    loss = GConvForecaster.loss

    def half(self, params, x, y, **kw):
        n = x.shape[0] // 2
        return loss(self, params, x[:n], y[:n], **kw)

    monkeypatch.setattr(GConvForecaster, "loss", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_training_faults_are_caught(manifest, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(manifest, FC)["correct"]


def test_altered_answer_is_caught(manifest, monkeypatch):
    from cnn_graph_tpu_torch import serve

    call = serve.CompiledServing.__call__

    def altered(self, x):
        out = call(self, x).clone()
        out[0, 0] += 0.1 * float(out.abs().max())
        return out

    monkeypatch.setattr(serve.CompiledServing, "__call__", altered)
    assert not _run(manifest, BF)["correct"]


@pytest.mark.parametrize("name", [FC, BF])
def test_controls_fail_at_a_tiny_size(manifest, name):
    limits = TINY[name]["limits"]
    r = control.readings(manifest, name, 41, torch.device("cpu"), TINY[name])
    assert set(r) == set(manifest.traffic(manifest.cell(name))["controls"])
    for kind, readings in r.items():
        assert any(readings[k] > v for k, v in limits.items()), (kind,
                                                                  readings)


@pytest.mark.parametrize("seed", [0, 3_000_000_017])
def test_flows_and_windows_are_the_programs(seed):
    """``datasets/synthetic_flow.py`` against the program's
    ``synthetic_flow`` and ``HumanTraffic``'s normalisation, windows and
    split, as ``load_ln_data_period`` runs them, cast to float32."""
    from cnn_graph_tpu_torch.data import HumanTraffic, synthetic_flow
    from harness import found

    spec = {"day": 48, "seq_closeness": 4, "seq_period": 3, "seq_trend": 3}
    ours = found.dataset("synthetic_flow", spec, (7, 700), seed)
    in_m, out_m, _ = synthetic_flow(n_nodes=7, n_steps=700, seed=seed)
    ht = HumanTraffic(".")
    in_m, out_m = ht.normalize(in_m, out_m)
    x, y = ht.make_windows(in_m, out_m, 4, 3, 3)
    theirs = ht.dataset_split(x, y)
    for key in ("train", "val", "test"):
        for got, want in zip(ours[key], (theirs[f"{key}_data"],
                                         theirs[f"{key}_labels"])):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want.astype(np.float32))


def test_work_counts_the_convs_by_hand(manifest):
    """The forecaster's K1 launches a step and a pass: 2 convs a cell step
    (x and h) over 2 layers x 16 steps, 10 stack and head convs forward;
    backward one ``L @ s`` for each conv whose input takes a gradient:
    not the first layer's x-conv, not the h-conv of a window's first
    step."""
    from models import forecaster as fc

    cfg = manifest.config(manifest.cell(FC))
    cfg["graph"] = _FC_CONFIG["graph"]
    p = fc.Problem(cfg, 1, torch.device("cpu"))
    _, fwd = p.forward_work(50)
    _, step = p.step_work(50)
    assert len(fwd) == 2 * 2 * 16 + 10 == 74
    # Per window of T steps: layer 0's h-conv T - 1, layer 1's x-conv T
    # and h-conv T - 1.
    assert len(step) - len(fwd) == sum(3 * T - 2 for T in (10, 3, 3)) + 10
