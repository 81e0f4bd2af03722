"""Kernel G's route and grid (``residual_route``, ``residual_plan``), on
the CPU: pure Python, no kernel and no JAX call.

* Up to ``W8_RESIDUAL_ROWS_MAX_M`` token rows G runs the decode-row strip
  (``csrc/w8_rows.cuh``, at most 32 rows), above w8_tile.cuh's tile, for
  every row count the pair gate admits (``STACK_KERNEL_MAX_M``).
* For every o and down shape of the repository's dense configs whose
  hidden size the pair gate takes (a multiple of 512), at every such row
  count: the splits divide the 128-deep K steps (at most 16); a strip
  split gives each of its 8 warps a 128-deep step; N = 4096 (Llama-3.1-8B)
  fills the card with strips alone, so no K split, and no ticket, runs
  there; a narrow N splits K to reach about one block an SM.
"""

import importlib

import pytest

from micromix_tpu_torch.models.common import STACK_KERNEL_MAX_M

# the module (the package exports a function of the same name)
mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")

# (N = hidden, K) of o (heads x head_dim) and down (intermediate):
# Llama-3.1-8B (chip_smoke.py, benchmarks/bench_8b_decode.py),
# __graft_entry__'s tiny Llama (hidden 512, 8 x 64 heads, intermediate
# 768), bench_8b_decode --quick (4 x 128 heads, 1024), bench_e2e's
# default (hidden 1024, 8 x 128 heads, intermediate 2048)
SHAPES = [(4096, 4096), (4096, 14336), (512, 512), (512, 768), (512, 1024),
          (1024, 1024), (1024, 2048)]
ROWS = sorted({1, 3, 8, 9, 16, 17, 32, 33, 40, 64, 65, 100, STACK_KERNEL_MAX_M})


def test_route_by_rows():
    assert mm.W8_RESIDUAL_ROWS_MAX_M <= mm._ROWS_MAX_M
    for m in range(1, STACK_KERNEL_MAX_M + 1):
        assert mm.residual_route(m) == (
            "rows" if m <= mm.W8_RESIDUAL_ROWS_MAX_M else "tile")


@pytest.mark.parametrize("n,k", SHAPES)
def test_plan_is_a_valid_grid(n, k):
    steps = k // 128
    for m in ROWS:
        routes = ["tile"] + (["rows"] if m <= mm._ROWS_MAX_M else [])
        for route in routes:
            blocks, d = mm.residual_plan(m, n, k, route)
            assert 1 <= d <= 16 and steps % d == 0, (m, route, d)
            if route == "rows":
                assert blocks == -(-n // mm._ROWS_STRIP)
                assert d == 1 or steps // d >= mm._ROWS_WARPS
                if blocks >= mm._ROWS_MIN_BLOCKS:
                    assert d == 1
            else:
                assert blocks == -(-n // 64) * -(-m // (16 if m <= 16 else 64))
                assert d == mm.split_k(m, n, k)


@pytest.mark.parametrize("n,k,d", [(4096, 4096, 1), (4096, 14336, 1),
                                   (512, 4096, 4), (512, 512, 1),
                                   (1024, 2048, 2), (512, 14336, 8)])
def test_strip_split(n, k, d):
    """No split where the strips fill the card; a narrow N splits K."""
    assert mm.residual_plan(8, n, k, "rows") == (-(-n // 32), d)


def test_rows_route_refuses_wide_rows():
    with pytest.raises(ValueError):
        mm.residual_plan(mm._ROWS_MAX_M + 1, 4096, 4096, "rows")
