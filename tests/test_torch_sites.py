"""Port parity: activation sites (Kernel A's function) and the ScaledW8
GEMM (Kernel B's function), held against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's wrappers get CPU tensors and so run their plain versions.

Tolerances:
  * plain-site images, the XLA fakequant chain and ScaledW8 weight
    images: bit-exact (==), all integer / power-of-two arithmetic;
  * rms and silu site images: the f32 row-moment sum order and the
    sigmoid's last bit can move a round-half-even tie to the adjacent
    grid step, so at most 1 in 1000 elements may differ, each by at most
    one grid step of its 32-block;
  * GEMM outputs: exact bf16 operands, f32 sums in another order, one
    bf16 rounding: |diff| <= 2^-7 |ref| + 2^-8 max|ref| (one bf16 ulp
    of slack either side of the rounding).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.kernels.fakequant import fakequant_site_pallas
from micromix_tpu.kernels.mixed_matmul import mixed_matmul as j_mixed_matmul
from micromix_tpu.kernels.mixed_matmul import mixed_matmul_w8 as j_w8
from micromix_tpu.kernels.mixed_matmul import mixed_matmul_w8_site as j_w8_site
from micromix_tpu.mx import layout as jlay
from micromix_tpu.mx.mxtensor import quantize_mixed as j_quantize_mixed
from micromix_tpu.mx.scaledw8 import pack_scaled_w8 as j_pack_w8
from micromix_tpu.ops import quantize_ops as jops
from micromix_tpu_torch.kernels.fakequant import (SITE_BLOCKS, SITE_PASS,
                                                  fakequant_site,
                                                  site_blocks_per_cta)
from micromix_tpu_torch.kernels.mixed_matmul import (
    mixed_matmul, mixed_matmul_w8, mixed_matmul_w8_site)
from micromix_tpu_torch.mx.scaledw8 import ScaledW8
from micromix_tpu_torch.ops import quantize_ops as tops

K4, K6, K8 = 256, 128, 128
K = K4 + K6 + K8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    """One f32 array -> the same bf16 values as a JAX and a torch array."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _assert_tie_band(got, ref, k4=K4, k6=K6, k8=K8):
    """At most 1/1000 of the elements differ, each by one grid step of
    its block (the largest step in a block with max |v| is
    2^(floor(log2 max|v|) - mantissa bits))."""
    diff = got != ref
    assert diff.mean() <= 1e-3, f"{int(diff.sum())} of {diff.size} differ"
    off = 0
    for kseg, mant in ((k4, 1), (k6, 2), (k8, 3)):
        g = got[:, off:off + kseg].reshape(got.shape[0], 32, -1)
        r = ref[:, off:off + kseg].reshape(ref.shape[0], 32, -1)
        bmax = np.maximum(np.abs(g).max(axis=1), np.abs(r).max(axis=1))
        step = np.exp2(np.floor(np.log2(np.maximum(bmax, 1e-30))) - mant)
        assert (np.abs(g - r) <= step[:, None, :]).all()
        off += kseg


def _assert_gemm_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))


_j_fakequant = jax.jit(lambda a: jops.fakequant_device(a, K4, K6, K8))


def _site_inputs(rng, m):
    x = rng.normal(0, 1, (m, K)).astype(np.float32)
    x[:, rng.choice(K, 8, replace=False)] *= 40.0       # outlier channels
    gamma = rng.normal(1, 0.1, (K,)).astype(np.float32)
    perm = jlay.compose_segmented(rng.permutation(K).astype(np.int32),
                                  K4, K6, K8)
    return x, gamma, perm


@pytest.mark.parametrize("m", [4, 130])
def test_plain_site_and_fakequant_device_bit_exact(rng, m):
    x, _, perm = _site_inputs(rng, m)
    jx, tx = _bf16_pair(x)
    ref_xla = _f32(jax.jit(lambda a, p: jops.reorder_fakequant_x(
        a, p, K4, K6, K8))(jx, jnp.asarray(perm)))
    got = _f32(tops.reorder_fakequant_x(tx, torch.from_numpy(perm), K4, K6, K8))
    np.testing.assert_array_equal(got, ref_xla)
    ref_pallas = _f32(fakequant_site_pallas(jnp.take(jx, jnp.asarray(perm), axis=1),
                                            K4, K6, K8, interpret=True))
    np.testing.assert_array_equal(got, ref_pallas)
    xp = x[:, perm]
    np.testing.assert_array_equal(
        _f32(tops.fakequant_device(torch.from_numpy(xp), K4, K6, K8)),
        _f32(_j_fakequant(jnp.asarray(xp))))


def test_rms_site_within_tie_band(rng):
    x, gamma, perm = _site_inputs(rng, 16)
    jx, tx = _bf16_pair(x)
    ref = _f32(jax.jit(lambda a, g, p: jops.rmsnorm_fakequant_x(
        a, g, p, K4, K6, K8, eps=1e-5))(jx, jnp.asarray(gamma),
                                        jnp.asarray(perm)))
    got = _f32(tops.rmsnorm_fakequant_x(tx, torch.from_numpy(gamma),
                                        torch.from_numpy(perm), K4, K6, K8,
                                        eps=1e-5))
    _assert_tie_band(got, ref)
    ref_pallas = _f32(fakequant_site_pallas(
        jnp.take(jx, jnp.asarray(perm), axis=1), K4, K6, K8, producer="rms",
        gamma=jnp.asarray(gamma[perm]), eps=1e-5, interpret=True))
    _assert_tie_band(got, ref_pallas)


def test_silu_site_within_tie_band(rng):
    g = rng.normal(0, 2, (16, K)).astype(np.float32)
    u = rng.normal(0, 2, (16, K)).astype(np.float32)
    jg, tg = _bf16_pair(g)
    ju, tu = _bf16_pair(u)
    ref = _f32(jax.jit(lambda a, b: jops.silu_mul_fakequant_x(
        a, b, K4, K6, K8))(jg, ju))
    got = _f32(tops.silu_mul_fakequant_x(tg, tu, K4, K6, K8))
    _assert_tie_band(got, ref)


def _weights(rng, n):
    w = rng.normal(0, 0.05, (n, K)).astype(np.float32)
    jw = jax.jit(lambda a: j_pack_w8(j_quantize_mixed(
        a, K4, K6, K8, weight_fp4_only=True, pack_fp4=True), check=False))(
            jnp.asarray(w))
    tw = ScaledW8(codes=torch.from_numpy(np.asarray(jw.codes)),
                  base=int(np.asarray(jw.base).reshape(-1)[0]),
                  k4=K4, k6=K6, k8=K8)
    return jw, tw


def _act_image(rng, m):
    x, _, _ = _site_inputs(rng, m)
    img = _f32(_j_fakequant(jnp.asarray(x)))
    return _bf16_pair(img)


def test_mixed_matmul_w8_matches_pallas(rng):
    jw, tw = _weights(rng, 256)
    ja, ta = _act_image(rng, 8)
    ref = _f32(j_w8(ja, jw, interpret=True))
    _assert_gemm_close(_f32(mixed_matmul_w8(ta, tw)), ref)


def test_mixed_matmul_prefill_branch_matches_jax(rng):
    """M >= 1024 dequantizes the weight and runs one dense product."""
    jw, tw = _weights(rng, 128)
    ja, ta = _act_image(rng, 1024)
    ref = _f32(jax.jit(j_mixed_matmul)(ja, jw))
    _assert_gemm_close(_f32(mixed_matmul(ta, tw)), ref)


@pytest.mark.parametrize("producer", ["plain", "rms", "silu"])
def test_mixed_matmul_w8_site_matches_pallas(rng, producer):
    jw, tw = _weights(rng, 256)
    x, gamma, perm = _site_inputs(rng, 8)
    jx, tx = _bf16_pair(x)
    jkw, tkw = {}, {}
    if producer == "silu":
        u = rng.normal(0, 1, x.shape).astype(np.float32)
        jkw["up"], tkw["up"] = _bf16_pair(u)
        jxg = jx
    else:
        jxg = jnp.take(jx, jnp.asarray(perm), axis=1)
        tkw["perm"] = torch.from_numpy(perm)
    if producer == "rms":
        jkw["gamma"] = jnp.asarray(gamma[perm])
        tkw["gamma"] = torch.from_numpy(gamma)
    jy, jqx = j_w8_site(jxg, jw, producer=producer, eps=1e-5, emit_qx=True,
                        interpret=True, **jkw)
    ty, tqx = mixed_matmul_w8_site(tx, tw, producer=producer, eps=1e-5,
                                   emit_qx=True, **tkw)
    if producer == "plain":
        np.testing.assert_array_equal(_f32(tqx), _f32(jqx))
    else:
        _assert_tie_band(_f32(tqx), _f32(jqx))
    # the GEMM half on the JAX image: isolates it from tie flips
    _assert_gemm_close(_f32(mixed_matmul_w8(_bf16_pair(_f32(jqx))[1], tw)),
                       _f32(jy))
    _assert_gemm_close(_f32(ty), _f32(jy))


def test_site_arguments_are_checked():
    x = torch.zeros((2, K), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fakequant_site(x, K4, K6, K8 + 32)
    with pytest.raises(ValueError):
        fakequant_site(x, K4, K6, K8, producer="silu", up=x,
                       perm=torch.arange(K, dtype=torch.int32))


def test_site_row_split_depends_on_shapes_only():
    """The site kernel's launch (M rows x S blocks, ``site_blocks_per_cta``
    32-blocks each) comes from M and K: decode rows split over enough
    blocks to cover the H100's 132 SMs (M = 8: 256), every 32-block in
    exactly one block, a split block one pass of its threads, whole rows
    from ``SITE_BLOCKS`` rows on."""
    for m, k in ((1, 4096), (8, 4096), (8, 14336), (130, 4096), (8, 4064),
                 (263, 4096), (264, 4096), (4096, 14336), (3, 512)):
        nbk = k // 32
        bpc = site_blocks_per_cta(m, k)
        splits = -(-nbk // bpc)
        assert (splits - 1) * bpc < nbk <= splits * bpc
        assert bpc >= min(4, nbk)
        assert bpc == nbk if m >= SITE_BLOCKS else bpc <= SITE_PASS
    assert 8 * -(-128 // site_blocks_per_cta(8, 4096)) >= 132
    assert 8 * -(-448 // site_blocks_per_cta(8, 14336)) >= 132
