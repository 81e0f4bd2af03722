"""Kernel B's split of K (``w8_gemm_split``): a divisor of the 128-deep K
steps, at most 16, for every row count; up to 64 rows the 64-row tile's
``split_k``; above, at the prefill shapes of the single ScaledW8 weights
(Llama-3.1-8B's o: N=4096 K=4096, down: N=4096 K=14336), the splits the
H100 sweep found fastest (``scripts/torch_w8_ablation.py --splits``)."""

import pytest

from micromix_tpu_torch.kernels.mixed_matmul import split_k, w8_gemm_split


@pytest.mark.parametrize("k", [512, 4096, 14336])
@pytest.mark.parametrize("n", [136, 4096, 14336])
def test_split_divides_the_steps(n, k):
    steps = k // 128
    for m in (1, 8, 16, 17, 64, 65, 128, 129, 300, 512, 1023):
        d = w8_gemm_split(m, n, k)
        assert 1 <= d <= 16 and steps % d == 0
        if m <= 64:
            assert d == split_k(m, n, k)


@pytest.mark.parametrize("m,n,k,d", [
    (128, 4096, 4096, 8), (128, 4096, 14336, 8), (256, 4096, 4096, 4),
    (300, 4096, 14336, 8), (512, 4096, 4096, 2), (512, 4096, 14336, 2),
    (512, 14336, 4096, 1), (1023, 4096, 14336, 1)])
def test_split_at_prefill_shapes(m, n, k, d):
    assert w8_gemm_split(m, n, k) == d
