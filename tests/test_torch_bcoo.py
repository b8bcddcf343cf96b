"""The port's BCOO operator (``device_laplacian(fmt="bcoo")``, a torch
sparse COO matrix multiplied by ``torch.sparse.mm``) against the JAX
package's ``BCOOLaplacian`` on the same NumPy inputs: its layout,
``matmul``, the hop and their gradients, ChebNet's and the
NodeClassifier's logits; its pass-through in ``quantize_model_operators``
and ``compile_serving(int8=True)``, as in JAX; ``export_serving``'s
refusal.

Tolerances: f32 products, hops and gradients 1e-5 of the max (sums in
another order); logits ``rtol=atol=1e-4``; bf16 products within one
bf16 ulp of the f32 product's rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import ChebNet as JaxChebNet
from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu_torch.convert import (
    chebnet_params_from_jax,
    node_classifier_params_from_jax,
)
from cnn_graph_tpu_torch.models import ChebNet, NodeClassifier
from cnn_graph_tpu_torch.models.common import quantize_model_operators
from cnn_graph_tpu_torch.ops import BCOOLaplacian, device_laplacian
from cnn_graph_tpu_torch.serve import compile_serving, export_serving


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(7)
    W = gc.knn_graph(rng.normal(size=(300, 5)).astype(np.float32), k=6)
    return gc.laplacian(W, normalized=True)


@pytest.fixture(scope="module")
def ops(graph):
    return (device_laplacian(graph, fmt="bcoo", device="cpu"),
            jax_device_laplacian(graph, fmt="bcoo"))


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_layout_matches_jax(ops):
    op, op_j = ops
    assert isinstance(op, BCOOLaplacian) and op.mat.is_sparse
    assert (op.m, op.m_padded, op.nnz) == (op_j.m, op_j.m_padded, op_j.nnz)
    assert op.m_padded == -(-op.m // 8) * 8
    np.testing.assert_array_equal(op.mat.to_dense().numpy(),
                                  np.asarray(op_j.bcoo.todense()))


def test_matmul_hop_and_gradients_match_jax(ops):
    op, op_j = ops
    rng = np.random.default_rng(1)
    x, x0, t = (rng.normal(size=(op.m_padded, 12)).astype(np.float32)
                for _ in range(3))
    xt, x0t = torch.from_numpy(x), torch.from_numpy(x0)
    _close(op.matmul(xt).numpy(), np.asarray(op_j.matmul(jnp.asarray(x))))
    _close(op.cheby_hop(xt, x0t).numpy(),
           np.asarray(op_j.cheby_hop(jnp.asarray(x), jnp.asarray(x0))))
    a, b = xt.clone().requires_grad_(), x0t.clone().requires_grad_()
    (op.cheby_hop(a, b) * torch.from_numpy(t)).sum().backward()
    g1, g0 = jax.grad(lambda u, v: jnp.sum(op_j.cheby_hop(u, v) * t),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(x0))
    _close(a.grad.numpy(), np.asarray(g1))
    _close(b.grad.numpy(), np.asarray(g0))


def test_bf16_operator_rounds_the_product(graph):
    op = device_laplacian(graph, fmt="bcoo", dtype=torch.bfloat16,
                          device="cpu")
    ref = device_laplacian(graph, fmt="bcoo", device="cpu")
    assert op.compute_dtype == torch.bfloat16
    x = torch.randn(op.m_padded, 8, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    got = op.matmul(x)
    assert got.dtype == torch.bfloat16
    want = ref.matmul(x.float())
    torch.testing.assert_close(got.float(), want, rtol=2**-7, atol=1e-2)


def test_node_classifier_logits_match_jax(ops):
    op, op_j = ops
    model_j = JaxNodeClassifier(op_j, 5, 3, hidden=[8], K=4)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(0)))
    model = NodeClassifier(op, 5, 3, hidden=[8], K=4)
    x = np.random.default_rng(2).normal(size=(op.m, 5)).astype(np.float32)
    with torch.no_grad():
        got = model.apply(node_classifier_params_from_jax(params_j),
                          torch.from_numpy(x))
    want = np.asarray(model_j.apply(params_j, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_chebnet_logits_match_jax(ops):
    op, op_j = ops
    arch = dict(F=[6], K=[4], p=[1], M=[16, 3])
    model_j = JaxChebNet([op_j], **arch)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(3)))
    model = ChebNet([op], **arch)
    x = np.random.default_rng(4).normal(size=(5, op.m)).astype(np.float32)
    with torch.no_grad():
        got = model.apply(chebnet_params_from_jax(params_j),
                          torch.from_numpy(x))
    want = np.asarray(model_j.apply(params_j, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_int8_conversion_passes_bcoo_through(ops):
    """BCOO has no int8 twin: ``quantize_model_operators`` and
    ``compile_serving(int8=True)`` keep it, as JAX's does
    (common.py:78); the float request is served unchanged."""
    op, _ = ops
    model = NodeClassifier(op, 5, 3, hidden=[8], K=4,
                           generator=torch.Generator().manual_seed(0))
    assert quantize_model_operators(model, sample_x=3.0).op is op
    params = model.param_tree()
    x = torch.randn(op.m_padded, 5, generator=torch.Generator().manual_seed(5))
    served = compile_serving(model, params, x, int8=True)
    with torch.no_grad():
        torch.testing.assert_close(served(x), model.apply(params, x))


def test_export_serving_refuses_bcoo(ops, tmp_path):
    op, _ = ops
    model = NodeClassifier(op, 5, 3, hidden=[], K=3)
    with pytest.raises(ValueError, match="BCOO operator"):
        export_serving(model, model.param_tree(), torch.zeros(op.m_padded, 5),
                       str(tmp_path / "art"))
