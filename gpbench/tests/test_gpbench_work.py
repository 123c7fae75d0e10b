"""The work counts and the least-time model (``gpbench/work``)."""

import pytest

from gpbench.work import FMA_OPS_PER_EXP, OPS, PEAKS, PRODUCT_FLOPS, Work, least_time, share, times
from gpbench.work import dense, gram, matrix_free


def test_least_time_is_the_slowest_resource():
    w = Work(products=PRODUCT_FLOPS * 2.0, ops=OPS * 1.0, bytes=PEAKS["hbm_bytes_per_s"] * 3.0)
    assert least_time(w) == pytest.approx(3.0)
    assert times(w)["products"] == pytest.approx(2.0)


def test_exps_use_both_routes_and_share_the_fp32_pipe():
    sfu = PEAKS["sfu_exps_per_s"]
    # Exps alone: both routes at once.
    assert least_time(Work(exps=1e12)) == pytest.approx(
        FMA_OPS_PER_EXP * 1e12 / (OPS + FMA_OPS_PER_EXP * sfu))
    # Few exps beside many instructions: the special-function units take
    # them all, and the pipe's instructions bound the time.
    assert least_time(Work(ops=OPS, exps=sfu * 0.5)) == pytest.approx(1.0)
    # The combined exp rate beats the special-function units alone.
    assert least_time(Work(exps=1e12)) < 1e12 / sfu


def test_share_is_percent_of_measured():
    w = Work(bytes=PEAKS["hbm_bytes_per_s"])
    assert share(w, 2.0) == pytest.approx(50.0)


def test_gram_matvec_counts():
    w = gram.matvec(4, 4, 3, symmetric=True)
    assert w.exps == 10 and w.ops == 3 * 10
    assert w.products == 2 * 4 * 4 * 3
    assert gram.matvec(4, 5, 3).exps == 20
    assert gram.matvec(4, 5, 3).bytes == 4 * (4 + 5 + 15 + 12)


def test_surrogate_products_are_those_of_all_ordered_pairs():
    n, q = 10, 17
    w = gram.surrogate_grad(n, q)
    assert w.exps == n * (n + 1) / 2
    assert w.products == pytest.approx(2 * q * n * (n + 1))


def test_matrix_free_step_is_surrogate_plus_one_solve_pass():
    c = {"n": 262_144, "num_probes": 16, "var_rank": 256, "chunk": 1024}
    step = matrix_free.step(c)
    assert step == matrix_free.gram_grad_launch(c) + matrix_free.gram_matvec_launch(c)
    # Bound by the products: 2 * 2 n^2 q flops at 165 TFLOP/s, about 28 ms.
    assert least_time(step) == pytest.approx(4 * 17 * 262_144 ** 2 / PRODUCT_FLOPS, rel=1e-3)
    assert 0.027 < least_time(step) < 0.030


def test_cholesky_tiles_follow_the_recursions_split():
    assert dense.tiles(2000) == [1024, 976]
    assert dense.tiles(1024) == [1024]
    assert dense.tiles(3000) == [1024, 1024, 952]
    assert sum(dense.tiles(5000)) == 5000


def test_dense_step_counts_three_cubic_products():
    c = {"n": 2000}
    assert dense.step(c).products == 2000 ** 3
    assert dense.chol_tiles(c).products == pytest.approx(2 / 3 * (1024 ** 3 + 976 ** 3))
    assert least_time(dense.step(c)) == pytest.approx(2000 ** 3 / PRODUCT_FLOPS)
