"""The H100 probes' plain versions (``cnn_graph_tpu_torch.utils.probes``)
against jax.numpy transcriptions of the Pallas probe bodies they replace,
on the CPU at small sizes.

``_mxu_probe``, ``_pred_probe`` and ``main_loopcost`` build their kernels
in closures and only time them, so nothing in ``experiments/_probe.py``
can be imported or run in interpret mode without editing it.  Each
``_jax_*`` below is the body of one kernel, line for line, as a
``fori_loop`` outside Pallas, with the carry's rows generalised from 128
to ``min(m, 128)`` so that it runs at m = 32.  The CUDA kernels are held
against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 18).

Tolerances: int8 bit-exact (exact integer accumulation, the same shift
and wrap); bf16 within 2e-2 of the max (f32 sums in another order, the
carries rounded to bf16 each iteration).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu_torch.utils import probes

M, N, TAPS, ITERS = 32, 64, 3, 3


def _jax_mxu(a, b, iters, taps):
    """``_mxu_probe``'s kernel body (_probe.py:155-181)."""
    int8 = a.dtype == jnp.int8
    dt = a.dtype
    acc_dt = jnp.int32 if int8 else jnp.float32
    m, n = a.shape[1], b.shape[2]
    rows = min(m, 128)

    def body(i, carry):
        if taps > 1:
            acc = jnp.zeros((m, n), acc_dt)
            for d in range(taps):
                if int8:
                    bb = (b[d].astype(jnp.int32)
                          + carry.astype(jnp.int32)).astype(jnp.int8)
                else:
                    bb = b[d] + carry
                acc += jnp.dot(a[d], bb, preferred_element_type=acc_dt)
        else:
            acc = jnp.dot(a[0], b[0], preferred_element_type=acc_dt)
            acc += jnp.dot(a[0][:, :rows], carry,
                           preferred_element_type=acc_dt)
        if int8:
            return (acc[:rows, :] >> 12).astype(dt)
        return (acc[:rows, :] * 1e-6).astype(dt)

    return jax.lax.fori_loop(0, iters, body, jnp.zeros((rows, n), dt))


def _jax_pred(widths, a, b, iters, cond):
    """``_pred_probe``'s kernel body (_probe.py:253-271)."""
    w_arr = jnp.asarray(np.asarray(widths, np.int32))
    nw = len(widths)
    taps, _, k0 = a.shape

    def body(i, carry):
        acc = jnp.dot(a[0], carry, preferred_element_type=jnp.float32)
        w_i = w_arr[jax.lax.rem(i, nw)]
        for d in range(taps):
            if cond:
                acc = jax.lax.cond(
                    d < w_i,
                    lambda x, d=d: x + jnp.dot(
                        a[d], b[d], preferred_element_type=jnp.float32),
                    lambda x: x,
                    acc,
                )
            else:
                acc += jnp.dot(a[d], b[d], preferred_element_type=jnp.float32)
        return (acc * 1e-6).astype(jnp.bfloat16)

    return jax.lax.fori_loop(0, iters, body,
                             jnp.zeros((k0, b.shape[2]), jnp.bfloat16))


def _jax_loopcost(seed, a, b, n_dots, unroll):
    """``main_loopcost``'s kernel body (_probe.py:393-409)."""
    T = a.shape[0]

    def body(i, acc):
        base = jax.lax.rem(i * unroll, T)
        for d in range(unroll):
            idx = jax.lax.rem(base + d, T)
            acc = acc + jnp.dot(a[idx], b[idx],
                                preferred_element_type=jnp.float32)
        return acc

    acc = jax.lax.fori_loop(0, n_dots // unroll, body,
                            seed.astype(jnp.float32))
    return (acc * 1e-3).astype(jnp.bfloat16)


def _operands(shapes, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return [rng.integers(-127, 128, s).astype(np.int8) for s in shapes]
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _pair(x, dtype):
    """The same values as a torch tensor and a jax array in ``dtype``."""
    if dtype == "int8":
        return torch.from_numpy(x), jnp.asarray(x)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _assert_matches(got: torch.Tensor, want, dtype):
    want = np.asarray(want.astype(jnp.float32)) if dtype != "int8" else \
        np.asarray(want)
    if dtype == "int8":
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


class TestReferencesAgainstJax:
    @pytest.mark.parametrize("taps", [TAPS, 1])
    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_mxu(self, dtype, taps):
        """P1 at m=32, n=64: three taps of depth 32 (the carry's rows), or
        one 96-deep dot plus the injection tap; 3 iterations.  bf16
        operands scaled by 300 so that the carry (acc * 1e-6) moves the
        next iteration's sums."""
        kd = M if taps > 1 else 3 * M
        a, b = (_pair(x, dtype) for x in _operands(
            [(taps, M, kd), (taps, kd, N)], dtype, seed=taps, scale=300.0))
        for iters in (1, ITERS):
            carry, extra = probes.mxu_reference(a[0], b[0], iters, taps)
            assert carry.shape == (1, M, N)
            assert not bool(extra.any())  # m = R: no row feeds it
            _assert_matches(carry[0], _jax_mxu(a[1], b[1], iters, taps),
                            dtype)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_mxu_rows_past_the_carry_fold_into_extra(self, dtype):
        """m = 256 (deepk_m256's form): rows 128.. feed no carry and are
        summed into ``extra``, chunk 1 each iteration, against a NumPy
        replay of the transcription's accumulators; replicas are copies."""
        a, b = _operands([(1, 256, 128), (1, 128, 128)], dtype, seed=5)
        ta, ja = _pair(a, dtype)
        tb, jb = _pair(b, dtype)
        carry, extra = probes.mxu_reference(ta, tb, ITERS, 1, replicas=2)
        _assert_matches(carry[1], _jax_mxu(ja, jb, ITERS, 1), dtype)
        assert torch.equal(carry[0], carry[1]) and torch.equal(extra[0],
                                                                extra[1])
        A = np.asarray(ja).astype(np.float64)[0]
        B = np.asarray(jb).astype(np.float64)[0]
        want = np.zeros((128, 128))
        for i in range(ITERS):
            c = np.asarray(_jax_mxu(ja, jb, i, 1)).astype(np.float64)
            want += (A @ B + A[:, :128] @ c)[128:]
        if dtype == "int8":
            assert extra.dtype == torch.int32
            np.testing.assert_array_equal(extra[0].numpy(),
                                          want.astype(np.int64))
        else:
            np.testing.assert_allclose(extra[0].numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())

    @pytest.mark.parametrize("variant", list(probes.PRED_VARIANTS))
    def test_pred(self, variant):
        """P2 at m = k0 = 32, n = 64, every variant's width table."""
        widths, cond = probes.PRED_VARIANTS[variant]
        a, b = (_pair(x, "bfloat16") for x in _operands(
            [(9, M, M), (9, M, N)], "bfloat16", seed=7, scale=300.0))
        for iters in (1, ITERS, 11):
            got = probes.pred_reference(widths, a[0], b[0], iters, cond)
            assert got.shape == (1, M, N)
            _assert_matches(got[0], _jax_pred(widths, a[1], b[1], iters,
                                              cond), "bfloat16")

    def test_pred_skips_taps(self):
        """Width 5 drops taps 5-8: cond_w5 differs from base9."""
        a, b = (_pair(x, "bfloat16")[0] for x in _operands(
            [(9, M, M), (9, M, N)], "bfloat16", seed=8))
        assert not torch.equal(probes.pred_reference([5], a, b, 2, True),
                               probes.pred_reference([9], a, b, 2, False))
        assert torch.equal(probes.pred_reference([9], a, b, 2, True),
                           probes.pred_reference([9], a, b, 2, False))

    @pytest.mark.parametrize("unroll", probes.LOOPCOST_UNROLLS)
    def test_loopcost(self, unroll):
        """P3 at [32, 32] @ [32, 64] from 16 pairs, 24 dots."""
        seed, a, b = (_pair(x, "bfloat16") for x in _operands(
            [(M, N), (16, M, M), (16, M, N)], "bfloat16", seed=unroll))
        got = probes.loopcost_reference(seed[0], a[0], b[0], 24, unroll)
        _assert_matches(got, _jax_loopcost(seed[1], a[1], b[1], 24, unroll),
                        "bfloat16")


class TestOperationCounts:
    @pytest.mark.parametrize("name,want", [
        ("tap9_bf16", 150_994_944), ("tap9_int8", 150_994_944),
        ("deepk_bf16", 167_772_160), ("deepk_int8", 167_772_160),
        ("deepk_m256", 335_544_320), ("sq1024", 2_415_919_104),
        ("i8_sq1024", 2_415_919_104)])
    def test_mxu(self, name, want):
        m, k, n, taps, _ = probes.MXU_SHAPES[name]
        formula = 2 * m * (k + (128 if taps == 1 else 0)) * n  # :208
        assert probes.mxu_flops(m, k, n, taps) == formula == want

    @pytest.mark.parametrize("name", list(probes.PRED_VARIANTS))
    def test_pred(self, name):
        widths, _ = probes.PRED_VARIANTS[name]
        m, k0, n = 128, 128, 512
        want = 2 * m * k0 * n * (float(np.mean(widths)) + 1)  # :299-300
        assert probes.pred_flops(widths) == want

    def test_loopcost(self):
        assert probes.loopcost_flops() == 2 * 128 * 128 * 512  # :435

    @pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
    def test_card_replicas_fill_two_ctas_per_sm(self, sms):
        for n in (512, 1024):
            r = probes.card_replicas(n, sms)
            assert r * n // 128 >= 2 * sms > (r - 1) * n // 128


BF16_MXU = [n for n, s in probes.MXU_SHAPES.items() if s[4] == torch.bfloat16]


class TestCheckOperands:
    """The operands the card's checks use (``check=True``) make the
    carry count: a kernel that dropped it (P1's ``b + carry`` or
    injection dot, P2's injection dot) fails ``probes.compare`` after 3
    iterations, where N(0, 1) operands let it pass.  With the carry
    dropped, every iteration repeats the first, so the dropped chain's
    output is the 1-iteration output (P2: at the third iteration's
    width)."""

    @pytest.mark.parametrize("name", BF16_MXU)
    def test_mxu_carry_dropped_fails(self, name):
        taps = probes.MXU_SHAPES[name][3]
        for check, caught in ((True, True), (False, False)):
            a, b = probes.mxu_operands(name, "cpu", check=check)
            want = probes.mxu_reference(a, b, 3, taps)[0]
            dropped = probes.mxu_reference(a, b, 1, taps)[0]
            assert bool(torch.isfinite(want.float()).all())
            probes.compare(want, want, 3)
            if caught:
                with pytest.raises(AssertionError):
                    probes.compare(dropped, want, 3)
            else:
                probes.compare(dropped, want, 3)

    @pytest.mark.parametrize("variant", list(probes.PRED_VARIANTS))
    def test_pred_injection_dropped_fails(self, variant):
        widths, cond = probes.PRED_VARIANTS[variant]
        for check, caught in ((True, True), (False, False)):
            a, b = probes.pred_operands("cpu", check=check)
            want = probes.pred_reference(widths, a, b, 3, cond)
            dropped = probes.pred_reference([widths[2 % len(widths)]], a, b,
                                            1, cond)
            if caught:
                with pytest.raises(AssertionError):
                    probes.compare(dropped, want, 3)
            else:
                probes.compare(dropped, want, 3)

    def test_int8_operands_are_unscaled(self):
        for name in ("tap9_int8", "deepk_int8"):
            for t, u in zip(probes.mxu_operands(name, "cpu"),
                            probes.mxu_operands(name, "cpu", check=True)):
                assert torch.equal(t, u)


class TestNoFallback:
    def test_mxu_probe_raises_without_cuda(self):
        a, b = torch.zeros(9, 128, 128, dtype=torch.bfloat16), torch.zeros(
            9, 128, 512, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="CUDA device only"):
            probes.mxu_probe(a, b, 1, 9)

    def test_pred_probe_raises_without_cuda(self):
        a, b = probes.pred_operands("cpu")
        with pytest.raises(RuntimeError, match="CUDA device only"):
            probes.pred_probe(torch.tensor([9], dtype=torch.int32), a, b, 1)

    def test_loopcost_probe_raises_without_cuda(self):
        seed, a, b = probes.loopcost_operands("cpu")
        with pytest.raises(RuntimeError, match="CUDA device only"):
            probes.loopcost_probe(seed, a, b, 16, 8)

    def test_cli(self, capsys):
        assert probes.main([]) == 2
        assert "probes" in capsys.readouterr().out
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                probes.main(["mxu", "4"])
