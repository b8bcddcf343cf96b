"""The stacked route of ``cheby_conv`` on bf16 operators against the JAX
package's on the same NumPy inputs.

JAX contracts the bf16 basis with ``preferred_element_type=x.dtype``
(cnn_graph_tpu/ops/filters.py:373-378): an f32 x gets an f32 y summed
from the bf16 products and never rounded to bf16.  Dense and BSR
operators (``use_pallas=False`` in both packages, so that both take the
stacked route) give the same bf16 basis, so the two y agree to f32
summation order: the bound is 1e-5 of max|y|.  A y rounded to bf16 is
off by up to half a bf16 ulp of its largest entries, 2^-9 of max|y|
(about 2e-3 here), and must fail that bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.data.synthetic import city_graph as jax_city_graph
from cnn_graph_tpu.ops import cheby_conv as jax_cheby_conv
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.ops import (
    BlockSparseLaplacian,
    DenseLaplacian,
    cheby_conv,
    device_laplacian,
)

TOL = 1e-5  # of max|y|: f32 sums of the same bf16 products, another order


@pytest.fixture(scope="module")
def city24():
    L, _ = graphs.city_graph(24, k=8, seed=0)
    L_jax, _ = jax_city_graph(24, k=8, seed=0)
    assert (abs(L - L_jax)).max() == 0
    return L


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, m, 8)).astype(np.float32)
    w = (0.3 * rng.normal(size=(5, 8, 4))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("fmt,cls", [("dense", DenseLaplacian),
                                     ("bsr", BlockSparseLaplacian)])
def test_bf16_operator_gives_f32_x_an_f32_y(city24, fmt, cls):
    op = device_laplacian(city24, fmt=fmt, dtype=torch.bfloat16,
                          use_pallas=False, device="cpu")
    assert isinstance(op, cls) and not getattr(op, "use_fused", False)
    op_j = jax_device_laplacian(city24, fmt=fmt, dtype=jnp.bfloat16,
                                use_pallas=False)
    x, w = _inputs(op.m)
    y = cheby_conv(torch.from_numpy(x), op, torch.from_numpy(w))
    want = np.asarray(jax_cheby_conv(jnp.asarray(x), op_j, jnp.asarray(w)))
    assert y.dtype == torch.float32 and want.dtype == np.float32
    scale = float(np.abs(want).max())
    err = float(np.abs(y.numpy() - want).max())
    assert err <= TOL * scale, (err, scale)
    # The old route's output, y rounded to bf16, fails the same bound.
    rounded = y.to(torch.bfloat16).to(torch.float32).numpy()
    assert float(np.abs(rounded - want).max()) > TOL * scale


def test_bf16_x_keeps_bf16(city24):
    """A bf16 x gets a bf16 y, as JAX's ``preferred_element_type``."""
    op = device_laplacian(city24, fmt="dense", dtype=torch.bfloat16,
                          use_pallas=False, device="cpu")
    x, w = _inputs(op.m, seed=1)
    y = cheby_conv(torch.from_numpy(x).to(torch.bfloat16), op,
                   torch.from_numpy(w))
    assert y.dtype == torch.bfloat16


def test_gradients_flow_through_the_f32_contraction(city24):
    """The route stays differentiable: dW against JAX's ``jax.grad`` of
    the same loss, within 1e-4 of its largest entry."""
    import jax

    op = device_laplacian(city24, fmt="bsr", dtype=torch.bfloat16,
                          use_pallas=False, device="cpu")
    op_j = jax_device_laplacian(city24, fmt="bsr", dtype=jnp.bfloat16,
                                use_pallas=False)
    x, w = _inputs(op.m, seed=2)
    wt = torch.from_numpy(w).requires_grad_()
    (cheby_conv(torch.from_numpy(x), op, wt) ** 2).sum().backward()
    g_j = np.asarray(jax.grad(
        lambda w_: (jax_cheby_conv(jnp.asarray(x), op_j, w_) ** 2).sum())(
            jnp.asarray(w)))
    err = float(np.abs(wt.grad.numpy() - g_j).max())
    assert err <= 1e-4 * float(np.abs(g_j).max()), err
