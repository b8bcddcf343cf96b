"""Whole runs of each cell on the CPU at a tiny size, past the harness's
look for a chip: the plain reference agrees with the program, and with
the timed path broken underneath, ``correct`` comes out false, once for
each fault the cell can have (a step that leaves its state unchanged,
half of the batch left out with the mean over the rest, an answer
altered where it is produced; no cell exchanges between chips)."""

import time

import pytest
import torch

from conftest import TINY, cell_of

SERVE = ["nodecls-city50k-serve-int8", "chebnet-mnist-serve-f32",
         "nodecls-serve-bf16", "nodecls-serve-loaded-hostfeat"]
TRAIN = ["nodecls-city50k-train-deep-bf16", "chebnet-mnist-train-f32"]


def _run(manifest, name, seed=2_700_000_123):
    from harness.runner import run_cell

    return run_cell(manifest, cell_of(manifest, name), seed, 0.3, False,
                    torch.device("cpu"), time.perf_counter(),
                    overrides=TINY[name], log=lambda s: None)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_run_is_correct(manifest, name):
    r = _run(manifest, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        # f32 or exact emulation at a tiny size
        assert c["value"] < TINY[name].get("sound", 1e-4)


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_caught(manifest, name, monkeypatch):
    from cnn_graph_tpu_torch import serve

    for handle in (serve.CompiledServing, serve.LoadedServing):
        call = handle.__call__

        def altered(self, x, call=call):
            out = call(self, x).clone()
            out[0, 0] += 0.1 * float(out.abs().max())
            return out

        monkeypatch.setattr(handle, "__call__", altered)
    assert not _run(manifest, name)["correct"]


def _unchanged_state(monkeypatch, name):
    if name.startswith("chebnet"):
        from cnn_graph_tpu_torch.train.trainer import Trainer

        monkeypatch.setattr(Trainer, "_train_step",
                            lambda self, p, s, ema, *a: (s, ema))
    else:
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)


def _half_batch(monkeypatch, name):
    if name.startswith("chebnet"):
        from cnn_graph_tpu_torch.models import ChebNet

        loss = ChebNet.loss

        def half(self, params, x, labels, **kw):
            n = x.shape[0] // 2
            return loss(self, params, x[:n], labels[:n], **kw)

        monkeypatch.setattr(ChebNet, "loss", half)
    else:
        from cnn_graph_tpu_torch.models import NodeClassifier

        loss = NodeClassifier.loss

        def half(self, params, feats, labels, mask=None, **kw):
            mask = mask & (torch.cumsum(mask, 0) <= mask.sum() // 2)
            return loss(self, params, feats, labels, mask, **kw)

        monkeypatch.setattr(NodeClassifier, "loss", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_are_caught(manifest, name, fault, monkeypatch):
    fault(monkeypatch, name)
    assert not _run(manifest, name)["correct"]
