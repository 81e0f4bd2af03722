"""Port parity: MX numerics, layout, quantized tensors and ScaledW8.

The same numpy inputs go through the JAX package's functions and the
port's (``micromix_tpu_torch.mx``).  Everything here is integer and
exact power-of-two arithmetic, so every comparison is bit-exact (==).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.mx import layout as jlay
from micromix_tpu.mx import numerics as jnx
from micromix_tpu.mx.formats import FP4, FP6, FP8
from micromix_tpu.mx.mxtensor import dequantize_mixed_device as j_dequant_dev
from micromix_tpu.mx.mxtensor import quantize_mixed as j_quantize_mixed
from micromix_tpu.mx.scaledw8 import dequantize_scaled_w8 as j_dequant_w8
from micromix_tpu.mx.scaledw8 import pack_scaled_w8 as j_pack_w8
from micromix_tpu_torch.mx import layout as tlay
from micromix_tpu_torch.mx import numerics as tnx
from micromix_tpu_torch.mx.mxtensor import dequantize_mixed_device as t_dequant_dev
from micromix_tpu_torch.mx.mxtensor import quantize_mixed as t_quantize_mixed
from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8 as t_dequant_w8
from micromix_tpu_torch.mx.scaledw8 import pack_scaled_w8 as t_pack_w8

FORMATS = [FP4, FP6, FP8]
K4, K6, K8 = 256, 128, 128


def _j(a):
    return np.asarray(a)


def _t(a):
    a = a.detach()
    if a.dtype == torch.bfloat16:
        a = a.to(torch.float32)
    return a.numpy()


def _values(rng, shape):
    """Normals over a wide exponent range, with exact zeros, grid ties
    and saturating magnitudes mixed in."""
    x = rng.normal(0, 1, shape) * np.exp2(rng.integers(-12, 12, shape))
    x = x.astype(np.float32)
    flat = x.reshape(-1)
    flat[::17] = 0.0
    flat[5::23] = 2.5          # fp4 round-half-even tie (2 | 3)
    flat[7::29] = -1e6         # saturates every format
    return x


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_grid_scale_encode_decode_bit_exact(rng, fmt):
    x = _values(rng, (64, 96))
    np.testing.assert_array_equal(
        _t(tnx.quantize_to_grid(torch.from_numpy(x), fmt)),
        _j(jnx.quantize_to_grid(jnp.asarray(x), fmt)))
    amax = np.abs(x).max(axis=-1)
    np.testing.assert_array_equal(
        _t(tnx.block_scale_exponent(torch.from_numpy(amax), fmt)),
        _j(jnx.block_scale_exponent(jnp.asarray(amax), fmt)))
    q = np.array(jnx.quantize_to_grid(jnp.asarray(x), fmt))
    codes = _t(tnx.encode(torch.from_numpy(q), fmt))
    np.testing.assert_array_equal(codes, _j(jnx.encode(jnp.asarray(q), fmt)))
    np.testing.assert_array_equal(
        _t(tnx.decode(torch.from_numpy(codes), fmt)),
        _j(jnx.decode(jnp.asarray(codes), fmt)))
    e = rng.integers(-126, 128, (257,)).astype(np.int32)
    np.testing.assert_array_equal(_t(tnx.exp2i(torch.from_numpy(e))),
                                  _j(jnx.exp2i(jnp.asarray(e))))


def test_layout_bit_exact(rng):
    x = rng.normal(0, 1, (8, 256)).astype(np.float32)
    np.testing.assert_array_equal(
        _t(tlay.interleave(torch.from_numpy(x))),
        _j(jlay.interleave(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _t(tlay.deinterleave(torch.from_numpy(x))),
        _j(jlay.deinterleave(jnp.asarray(x))))
    perm = rng.permutation(512).astype(np.int32)
    np.testing.assert_array_equal(
        tlay.compose_segmented(perm, K4, K6, K8),
        jlay.compose_segmented(perm, K4, K6, K8))


@pytest.mark.parametrize("fp4_only", [False, True], ids=["mixed", "fp4_only"])
def test_quantize_mixed_codes_and_scales_bit_exact(rng, fp4_only):
    x = _values(rng, (24, K4 + K6 + K8))
    jt = jax.jit(lambda a: j_quantize_mixed(a, K4, K6, K8,
                                            weight_fp4_only=fp4_only))(
        jnp.asarray(x))
    tt = t_quantize_mixed(torch.from_numpy(x), K4, K6, K8,
                          weight_fp4_only=fp4_only)
    for name in ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8"):
        np.testing.assert_array_equal(_t(getattr(tt, name)),
                                      _j(getattr(jt, name)), err_msg=name)
    np.testing.assert_array_equal(
        _t(t_dequant_dev(tt, torch.float32)), _j(j_dequant_dev(jt, jnp.float32)))


def test_scaledw8_pack_and_decode_bit_exact(rng):
    w = rng.normal(0, 0.05, (96, K4 + K6 + K8)).astype(np.float32)
    w[3, :40] = 0.0
    # jitted, so the range check (which needs concrete values) is off on
    # the JAX side; the port's pack always checks
    jw = jax.jit(lambda a: j_pack_w8(j_quantize_mixed(
        a, K4, K6, K8, weight_fp4_only=True, pack_fp4=True), check=False))(
            jnp.asarray(w))
    tw = t_pack_w8(t_quantize_mixed(torch.from_numpy(w), K4, K6, K8,
                                    weight_fp4_only=True))
    np.testing.assert_array_equal(_t(tw.codes), _j(jw.codes))
    assert tw.base == int(_j(jw.base).reshape(-1)[0])
    assert tw.segments() == jw.segments()
    np.testing.assert_array_equal(
        _t(t_dequant_w8(tw, torch.float32)), _j(j_dequant_w8(jw, jnp.float32)))
    np.testing.assert_array_equal(
        _t(t_dequant_w8(tw, torch.bfloat16)),
        _j(j_dequant_w8(jw, jnp.bfloat16).astype(jnp.float32)))


def test_scaledw8_span_over_62_raises():
    w = np.zeros((4, 128), np.float32)
    w[0, 0] = 2.0 ** 40
    w[1, 32] = 2.0 ** -40
    tq = t_quantize_mixed(torch.from_numpy(w), 128, 0, 0, weight_fp4_only=True)
    with pytest.raises(ValueError, match="exceeds 62"):
        t_pack_w8(tq)


def test_mixed_matmul_refuses_other_segment_budgets():
    """ROADMAP 3.5: a ScaledW8 weight packed for (512, 256, 256) and
    activation codes of (768, 128, 128) (M=8, N=256, K=1024, seed 0).
    The codes decode in their own segments' column order, not the
    weight's, so both packages refuse: JAX's ``mixed_matmul`` asserts,
    the port raises ``ValueError`` (as ``mixed_matmul_sp`` does).  Equal
    budgets still multiply."""
    from micromix_tpu.kernels.mixed_matmul import mixed_matmul as j_mm
    from micromix_tpu.mx.mxtensor import MixedTensor as JMixed
    from micromix_tpu.mx.scaledw8 import ScaledW8 as JW8
    from micromix_tpu_torch.kernels.mixed_matmul import mixed_matmul as t_mm
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (8, 1024)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (256, 1024)).astype(np.float32))
    ta = t_quantize_mixed(x, 768, 128, 128)
    tw = t_pack_w8(t_quantize_mixed(w, 512, 256, 256, weight_fp4_only=True,
                                    pack_fp4=True))
    ja = JMixed(**{f: jnp.asarray(_t(getattr(ta, f)))
                   for f in ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")})
    jw = JW8(codes=jnp.asarray(_t(tw.codes)),
             base=jnp.full((1, 1), tw.base, jnp.int32), k4=512, k6=256, k8=256)
    with pytest.raises(AssertionError, match=r"\(768, 128, 128\)"):
        j_mm(ja, jw)
    with pytest.raises(ValueError, match=r"\(768, 128, 128\)"):
        t_mm(ta, tw)
    same = t_quantize_mixed(x, 512, 256, 256)
    np.testing.assert_array_equal(
        _t(t_mm(same, tw)), _t(t_mm(t_dequant_dev(same, torch.bfloat16), tw)))
