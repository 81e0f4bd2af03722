"""Port parity for the split-plane ("capacity-first") layout: fp4 packing,
the activation MX quantize (Kernel J's function), the split-plane GEMM
(Kernel K's) and stacked GEMM (Kernel L's), surgery with
``layout="splitplane"`` and the exponent-span fallback, stacking and
conversion, the forward, prefill + greedy decode and the engine, held
against the JAX package on the CPU at small widths.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do, each call once per module where several tests read it; the port's
wrappers get CPU tensors and run their plain versions.

Tolerances:
  * fp4 packing, weight codes and scales, the plain-producer quantize
    (zero blocks, negative zeros, saturation, k4 % 256 == 128 included),
    conversion and stacking: bit-exact (integer and exact f32 arithmetic);
  * rms / silu quantize: the decoded codes within the RNE tie band (at
    most 1 element in 1000 one grid step of its 32-block away: the f32
    row-moment sum order and the sigmoid's last bit can move a tie);
  * GEMM outputs on the same codes: the same exact bf16 operands summed in
    f32 in another order (the JAX kernel sums four partial dots), one bf16
    rounding: |diff| <= 2^-7 |ref| + 2^-8 max|ref|;
  * stacked outputs behind an rms / silu site: the JAX package's band for
    a flipped tie (rtol 0.05, atol 1.0, median |diff| <= 0.25,
    tests/test_mixed_matmul_kernel.py test_pair_kernel_matches_unfused_chain);
  * the stacked GEMM on a site image against the quantize followed by the
    split-plane GEMM on each section: bit-exact (the image is the exact
    decode of the codes, and the plain versions sum alike);
  * forward logits: within 2% of the logit range and the same argmax
    (as tests/test_torch_model.py); greedy tokens: equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _llama_cfg
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.kernels.mixed_matmul import mixed_matmul as j_mixed_matmul
from micromix_tpu.kernels.mixed_matmul import mixed_matmul_sp_stack as j_sp_stack
from micromix_tpu.kernels.quantize import quantize_mixed_pallas
from micromix_tpu.models import forward as j_forward
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.mx import layout as jlay
from micromix_tpu.mx import mxtensor as jmx
from micromix_tpu.mx import numerics as jnx
from micromix_tpu.ops import quantize_ops as jops
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.convert import from_jax_params, mixed_from_jax
from micromix_tpu_torch.kernels.fakequant import fakequant_site
from micromix_tpu_torch.kernels.mixed_matmul import (
    mixed_matmul, mixed_matmul_sp, mixed_matmul_sp_plain, mixed_matmul_sp_stack,
    sp_split_k, sp_stack_gemm)
from micromix_tpu_torch.kernels.quantize import quantize_mixed as t_quantize
from micromix_tpu_torch.models import common as tcommon
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models import transformer as ttr
from micromix_tpu_torch.models.common import ModelConfig, QuantLinear
from micromix_tpu_torch.mx import numerics as tnx
from micromix_tpu_torch.mx.mxtensor import (
    MixedTensor, SplitPlaneStack, dequantize_mixed, dequantize_mixed_device,
    quantize_mixed, section_mixed, stack_split_plane)
from micromix_tpu_torch.ops.quantize_ops import (activation_quantize,
                                                 rmsnorm_quantize_x,
                                                 silu_mul_quantize_x)
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve import runner as trunner

SPLITS = (256, 128, 128)
ODD = (384, 128, 0)          # k4 % 256 == 128: k4/2 = 192 is no multiple of 128
FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")
PS, MP = 16, 8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _to_jax(t: MixedTensor) -> jmx.MixedTensor:
    return jmx.MixedTensor(**{f: jnp.asarray(getattr(t, f).numpy()) for f in FIELDS},
                           fp4_packed=t.fp4_packed, fp4_only=t.fp4_only)


def _assert_mixed_equal(t: MixedTensor, j) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.fp4_packed, t.fp4_only) == (j.fp4_packed, j.fp4_only)


def _assert_gemm_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))


def _assert_tie_band(got, ref, splits):
    diff = got != ref
    assert diff.mean() <= 1e-3, f"{int(diff.sum())} of {diff.size} differ"
    off = 0
    for kseg, mant in zip(splits, (1, 2, 3)):
        if kseg:
            g = got[:, off:off + kseg].reshape(got.shape[0], 32, -1)
            r = ref[:, off:off + kseg].reshape(ref.shape[0], 32, -1)
            bmax = np.maximum(np.abs(g).max(axis=1), np.abs(r).max(axis=1))
            step = np.exp2(np.floor(np.log2(np.maximum(bmax, 1e-30))) - mant)
            assert (np.abs(g - r) <= step[:, None, :]).all()
        off += kseg


def _assert_pair_band(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=1.0)
    assert np.median(np.abs(got - ref)) <= 0.25


def _weight(rng, n, splits, fp4_only=True):
    """A random split-plane weight (port quantizer, bit-identical to the
    JAX package's: test_quantize_mixed_packed_matches_jax)."""
    w = torch.from_numpy(rng.normal(0, 0.3, (n, sum(splits))).astype(np.float32))
    return quantize_mixed(w, *splits, weight_fp4_only=fp4_only, pack_fp4=True)


def _hard_activations(rng, m, k):
    """Rows with zero blocks, exact and rounded negative zeros, values at
    the top of the f32 range (scale exponent 126) and tiny values.  No
    block mixes magnitudes so far apart that a scaled member is an f32
    subnormal: XLA's CPU flushes those to zero, IEEE arithmetic (the
    port's, on the CPU and the card) keeps them."""
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    x[:, rng.choice(k, 6, replace=False)] *= 40.0
    x[0] = 0.0                                      # all blocks zero
    x[1, :] = -0.0                                  # negative zeros
    x[2, ::3] = -1e-6                               # rounds to -0 beside 1.0
    x[2, 1::3] = 1.0
    x[3] = np.where(x[3] < 0, -3e38, 3e38)          # scale exponent 126
    x[4] *= 1e-30                                   # tiny scales
    return x


# ------------------------------------------------------------ numerics


def test_pack_unpack_fp4_matches_jax(rng):
    codes = rng.integers(0, 16, (5, 384)).astype(np.uint8)
    got = tnx.pack_fp4(torch.from_numpy(codes))
    ref = np.asarray(jnx.pack_fp4(jnp.asarray(codes)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tnx.unpack_fp4(got).numpy(), codes)
    np.testing.assert_array_equal(np.asarray(jnx.unpack_fp4(jnp.asarray(ref))), codes)


@pytest.mark.parametrize("fp4_only", [True, False])
@pytest.mark.parametrize("splits", [SPLITS, ODD])
def test_quantize_mixed_packed_matches_jax(rng, fp4_only, splits):
    """Weight quantize with the fp4 plane packed, codes and scales against
    the JAX package's, and both dequantizations (canonical and device
    order) against its, bit for bit."""
    x = rng.normal(0, 0.3, (24, sum(splits))).astype(np.float32)
    x[3, :40] = 0.0
    x[5, 7] = 1e4
    t = quantize_mixed(torch.from_numpy(x), *splits, weight_fp4_only=fp4_only,
                       pack_fp4=True)
    j = jax.jit(jmx.quantize_mixed, static_argnums=(1, 2, 3, 4, 5))(
        jnp.asarray(x), *splits, fp4_only, True)
    _assert_mixed_equal(t, j)
    assert t.segments() == j.segments() and t.k4 == j.k4
    np.testing.assert_array_equal(dequantize_mixed(t).numpy(),
                                  np.asarray(jmx.dequantize_mixed(j)))
    np.testing.assert_array_equal(
        dequantize_mixed_device(t, torch.float32).numpy(),
        np.asarray(jmx.dequantize_mixed_device(j, jnp.float32)))


@pytest.fixture(scope="module")
def pallas_quantized():
    """quantize_mixed_pallas(interpret=True) of hard activations, once per
    segment split."""
    rng = np.random.default_rng(11)
    out = {}
    for splits in (SPLITS, ODD):
        x = _hard_activations(rng, 9, sum(splits))
        out[splits] = (x, quantize_mixed_pallas(jnp.asarray(x), *splits,
                                                interpret=True))
    return out


@pytest.mark.parametrize("splits", [SPLITS, ODD])
def test_quantize_plain_matches_pallas_bit_exact(pallas_quantized, splits):
    x, ref = pallas_quantized[splits]
    got = activation_quantize(torch.from_numpy(x), *splits)
    _assert_mixed_equal(got, ref)
    assert got.fp4[1].eq(0).all()                      # -0.0 -> +0
    assert got.fp4[2].eq(0x8).any()                    # rounded -> -0 code


@pytest.mark.parametrize("producer", ["rms", "silu"])
def test_quantize_producers_match_jax(rng, producer):
    """rmsnorm / silu producers in front of the quantize, against the JAX
    ops on their XLA path (the Pallas kernel's values, checked above)."""
    k = sum(SPLITS)
    jx, tx = _bf16_pair(rng.normal(0, 1, (6, k)).astype(np.float32))
    if producer == "rms":
        perm = jlay.compose_segmented(rng.permutation(k).astype(np.int32), *SPLITS)
        gamma = rng.normal(1, 0.1, (k,)).astype(np.float32)
        ref = jax.jit(lambda x, g, p: jops.rmsnorm_quantize_x(
            x, g, p, *SPLITS, eps=1e-5, use_pallas=False))(
                jx, jnp.asarray(gamma), jnp.asarray(perm))
        got = rmsnorm_quantize_x(tx, torch.from_numpy(gamma),
                                 torch.from_numpy(perm), *SPLITS, eps=1e-5)
    else:
        ju, tu = _bf16_pair(rng.normal(0, 1, (6, k)).astype(np.float32))
        ref = jax.jit(lambda g, u: jops.silu_mul_quantize_x(
            g, u, *SPLITS, use_pallas=False))(jx, ju)
        got = silu_mul_quantize_x(tx, tu, *SPLITS)
    _assert_tie_band(_f32(dequantize_mixed_device(got, torch.float32)),
                     np.asarray(jmx.dequantize_mixed_device(ref, jnp.float32)),
                     SPLITS)


# --------------------------------------------------------------- GEMMs


@pytest.mark.parametrize("fp4_only,splits", [(True, SPLITS), (False, SPLITS),
                                             (True, ODD)])
def test_sp_gemm_plain_matches_pallas(fp4_only, splits):
    """Kernel K's plain version against mixed_matmul(interpret=True) on the
    same codes; N = 200 is no multiple of the JAX strip."""
    rng = np.random.default_rng(3)
    a = activation_quantize(torch.from_numpy(
        _hard_activations(rng, 7, sum(splits))[4:] + rng.normal(
            0, 1, (3, sum(splits))).astype(np.float32)), *splits)
    w = _weight(rng, 200, splits, fp4_only)
    ref = _f32(j_mixed_matmul(_to_jax(a), _to_jax(w), interpret=True))
    got = mixed_matmul(a, w)
    assert got.shape == (3, 200) and got.dtype == torch.bfloat16
    _assert_gemm_close(_f32(got), ref)
    assert torch.equal(got, mixed_matmul_sp(a, w))


def test_mixed_matmul_dispatch_and_splits(rng):
    """From 512 rows both operands are dequantized for one dense product
    (the plain version's function on the CPU); K splits depend on M and K
    only and divide the 128-column steps."""
    a = activation_quantize(torch.from_numpy(
        rng.normal(0, 1, (512, 512)).astype(np.float32)), *SPLITS)
    w = _weight(rng, 64, SPLITS)
    assert torch.equal(mixed_matmul(a, w), mixed_matmul_sp_plain(a, w))
    assert [sp_split_k(m, k) for m, k in (
        (8, 4096), (8, 14336), (64, 14336), (128, 14336), (128, 4096),
        (256, 14336), (256, 4096), (1, 512))] == [4, 14, 4, 7, 2, 2, 1, 1]
    with pytest.raises(TypeError):
        mixed_matmul(a, object())


@pytest.fixture(scope="module")
def pallas_sp_stack():
    """mixed_matmul_sp_stack(interpret=True) for the plain, rms and silu
    producers on one random problem each."""
    rng = np.random.default_rng(5)
    k = sum(SPLITS)
    out = {}
    for producer in ("plain", "rms", "silu"):
        ns = (256,) if producer == "silu" else (256, 120, 128)
        ws = [_weight(rng, n, SPLITS) for n in ns]
        x = rng.normal(0, 1, (5, k)).astype(np.float32)
        x[:, rng.choice(k, 6, replace=False)] *= 30.0
        jx, tx = _bf16_pair(x)
        jkw, tkw = {}, {}
        if producer == "silu":
            ju, tu = _bf16_pair(rng.normal(0, 0.25, (5, k)).astype(np.float32))
            jkw = dict(producer="silu", up=ju)
            tkw = dict(producer="silu", up=tu)
        else:
            perm = jlay.compose_segmented(rng.permutation(k).astype(np.int32), *SPLITS)
            jx = jnp.take(jx, jnp.asarray(perm), axis=1)
            tkw["perm"] = torch.from_numpy(perm)
            if producer == "rms":
                gamma = rng.normal(1, 0.1, (k,)).astype(np.float32)
                jkw = dict(producer="rms", gamma=jnp.asarray(gamma[perm]), eps=1e-5)
                tkw.update(producer="rms", gamma=torch.from_numpy(gamma), eps=1e-5)
        jst = jmx.stack_split_plane([_to_jax(w) for w in ws])
        ref = [_f32(r) for r in j_sp_stack(jx, jst, interpret=True, **jkw)]
        out[producer] = (ws, jst, tx, tkw, ref)
    return out


@pytest.mark.parametrize("producer", ["plain", "rms", "silu"])
def test_sp_stack_plain_matches_pallas(pallas_sp_stack, producer):
    """Kernel L's plain version (behind the site) against
    mixed_matmul_sp_stack(interpret=True), on the port's own stack and on
    the JAX stack carried over with its padding; then the fakequant-direct
    equivalence: the stacked GEMM equals the quantize followed by the
    split-plane GEMM on each section, bit for bit."""
    ws, jst, tx, tkw, ref = pallas_sp_stack[producer]
    st = stack_split_plane(ws)
    carried = SplitPlaneStack(mt=mixed_from_jax(jax.tree.map(np.asarray, jst.mt), "cpu"),
                              biases=(None,) * len(ws), sections=tuple(jst.sections),
                              padded=tuple(jst.padded))
    assert st.padded == carried.padded and st.sections == carried.sections
    for f in FIELDS:
        assert torch.equal(getattr(st.mt, f), getattr(carried.mt, f)), f
    got = mixed_matmul_sp_stack(tx, st, **tkw)
    assert [tuple(g.shape) for g in got] == [(5, w.rows) for w in ws]
    for g, r in zip(got, ref):
        (_assert_gemm_close if producer == "plain" else _assert_pair_band)(_f32(g), r)
    qa = t_quantize(tx, *SPLITS, **tkw)
    img = fakequant_site(tx, *SPLITS, **tkw)
    assert torch.equal(dequantize_mixed_device(qa), img)
    for i, g in enumerate(got):
        assert torch.equal(g, mixed_matmul_sp(qa, section_mixed(st, i)))
    for g, h in zip(sp_stack_gemm(img, st), got):
        assert torch.equal(g, h)


def test_stack_split_plane_padding_and_no_copy_wrap(rng):
    """The JAX package's padding rule (strips of 512 down to 128, pad rows
    zero codes and zero scales, decoding to 0.0, not NaN); a single
    strip-aligned weight wraps without a copy."""
    ws = [_weight(rng, n, SPLITS) for n in (256, 120)]
    st = stack_split_plane(ws)
    assert st.padded == (256, 128)
    dq = dequantize_mixed_device(st.mt, torch.float32)
    assert dq.shape == (384, sum(SPLITS)) and torch.isfinite(dq).all()
    assert dq[376:].eq(0).all()
    assert st.mt.sf4[376:].eq(0).all() and st.mt.fp4[376:].eq(0).all()
    one = stack_split_plane([ws[0]])
    assert one.padded == (256,)
    for f in FIELDS:
        assert getattr(one.mt, f).data_ptr() == getattr(ws[0], f).data_ptr(), f
    with pytest.raises(ValueError):
        stack_split_plane([ws[0], _weight(rng, 128, ODD)])


# ------------------------------------------------- surgery, conversion


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, JAX split-plane params, the port's own from the same
    dense weights)."""
    jcfg = _llama_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=2), jcfg,
        jsurg.default_calibration(jcfg, p6=128, p8=128, seed=2), host=True,
        layout="splitplane")
    tparams = tsurg.quantize_model(
        tsurg.random_dense_params(tcfg, seed=2, device="cpu"), tcfg,
        tsurg.default_calibration(tcfg, p6=128, p8=128, seed=2),
        layout="splitplane")
    return jcfg, tcfg, jparams, tparams


def test_surgery_splitplane_matches_jax_and_conversion(model):
    """layout="splitplane": every linear a packed MixedTensor, codes and
    scales bit-exact with the JAX package's, and the converted JAX params
    the same tensors."""
    jcfg, tcfg, jparams, tparams = model
    conv = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for jl, tl, cl in zip(jparams["layers"], tparams["layers"], conv["layers"]):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            assert isinstance(tl[name].w, MixedTensor) and tl[name].w.fp4_packed
            _assert_mixed_equal(tl[name].w, jl[name].w)
            for f in FIELDS:
                assert torch.equal(getattr(cl[name].w, f), getattr(tl[name].w, f))


def test_auto_layout_falls_back_to_split_plane():
    """"auto" keeps a weight split-plane when its scaled-exponent span
    exceeds 62, and when it is not fp4-only; the JAX package does the
    same with the same codes."""
    rng = np.random.default_rng(4)
    k = sum(SPLITS)
    w = rng.normal(0, 1, (64, k)).astype(np.float32)
    w[:32] *= 2.0 ** -70
    calib = tsurg.SiteCalibration(rng.permutation(k).astype(np.int32), 128, 128)
    jcal = jsurg.SiteCalibration(calib.reorder_index, 128, 128)
    for fp4_only, wide in ((True, w), (False, w[32:])):
        got = tsurg.quantize_linear(torch.from_numpy(wide), calib,
                                    weight_fp4_only=fp4_only).w
        ref = jsurg.quantize_linear(jnp.asarray(wide), jcal, host=True,
                                    weight_fp4_only=fp4_only).w
        assert isinstance(got, MixedTensor) and isinstance(ref, jmx.MixedTensor)
        _assert_mixed_equal(got, ref)
    assert not isinstance(tsurg.quantize_linear(torch.from_numpy(w[32:]),
                                                calib).w, MixedTensor)


def test_stack_layer_projections_splitplane(model):
    """The port's stacking of split-plane params and the conversion of the
    JAX package's stacked pytree: SplitPlaneStacks with the same arrays,
    sections and padding; the per-weight entries removed; o and down left
    per consumer."""
    jcfg, tcfg, jparams, tparams = model
    mine = tsurg.stack_layer_projections(tparams)
    carried = from_jax_params(
        jax.tree.map(np.asarray, jsurg.stack_layer_projections(jparams)),
        tcfg, device="cpu")
    for a_layer, b_layer in zip(mine["layers"], carried["layers"]):
        for key, names in (("qkv_stack", "qkv"), ("gateup_stack", ("gate", "up"))):
            a, b = a_layer[key], b_layer[key]
            assert isinstance(a, SplitPlaneStack) and isinstance(b, SplitPlaneStack)
            assert all(n not in a_layer for n in names)
            assert (a.sections, a.padded) == (b.sections, b.padded)
            for f in FIELDS:
                assert torch.equal(getattr(a.mt, f), getattr(b.mt, f)), (key, f)
        assert isinstance(a_layer["o"].w, MixedTensor)
    assert not trunner._can_pair(mine, tcfg, 4)


# ---------------------------------------------------------- end to end


def test_forward_logits_match_jax(model):
    """Per-consumer split-plane params through both forwards (the JAX one
    with its flash kernel, as on the TPU): the quantize (J), the
    split-plane GEMM (K) for q/k/v and gate/up, the one-section stack (A +
    L) for o, the silu quantize and K for down at 32 rows on the JAX side
    and L on the port's (<= 128 rows, fakequant-direct)."""
    jcfg, tcfg, jparams, tparams = model
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 32))
    ref = np.asarray(jax.jit(lambda p, t: j_forward(p, jcfg, t, use_flash=True))(
        jparams, jnp.asarray(tokens, jnp.int32)))
    got = ttr.forward(tparams, tcfg, torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (1, 32, jcfg.vocab_size)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.02
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_prefill_and_decode_greedy_match_jax(model, monkeypatch):
    """Stacked split-plane params, a 13-token prompt (bucket 16) and 6
    greedy decode steps through the unpaired loop: every projection of a
    decode step goes through the stacked split-plane GEMM (4 per layer),
    as on the JAX package's TPU path; greedy tokens equal JAX's."""
    jcfg, tcfg, jparams, tparams = model
    monkeypatch.setattr(jrunner, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    jparams = jsurg.stack_layer_projections(jparams)
    tparams = tsurg.stack_layer_projections(tparams)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, 13)
    row = np.array([3, 1, 4, 0, 0, 0, 0, 0], np.int32)
    nkv, hd = jcfg.num_kv_heads, jcfg.head_dim
    jc = [dataclasses.replace(jkv.make_cache(6, PS, nkv, hd, 2, MP),
                              page_table=jnp.zeros((2, MP), jnp.int32).at[0].set(row))
          for _ in range(jcfg.num_layers)]
    tc = [tkv.make_cache(6, PS, nkv, hd, 2, MP, device="cpu") for _ in range(jcfg.num_layers)]
    for c in tc:
        c.page_table[0] = torch.from_numpy(row)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompt
    jlog, jc = jax.jit(lambda p, c, t: jrunner.prefill(
        p, jcfg, c, t, jnp.int32(0), jnp.int32(0), jnp.int32(12)))(
            jparams, jc, jnp.asarray(toks))
    tlog, tc = trunner.prefill(tparams, tcfg, tc, torch.from_numpy(toks), 0,
                               last_idx=12)
    first = int(np.argmax(np.asarray(jlog)[0]))
    assert int(torch.argmax(tlog[0])) == first
    jc = [dataclasses.replace(c, lengths=c.lengths.at[0].set(13)) for c in jc]
    for c in tc:
        c.lengths[0] = 13
    calls = []
    for mod in (tcommon, ttr):
        real = getattr(mod, "mixed_matmul_sp_stack")
        monkeypatch.setattr(mod, "mixed_matmul_sp_stack",
                            lambda *a, _real=real, **kw: calls.append(1) or _real(*a, **kw))
    z = np.zeros((1,), np.float32)
    jtoks, _ = jax.jit(lambda p, c: jrunner.decode_multi(
        p, jcfg, c, jnp.asarray([first], jnp.int32), jnp.asarray([0], jnp.int32),
        jnp.asarray([13], jnp.int32), jax.random.PRNGKey(0), jnp.asarray(z),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.float32), n_steps=6,
        sample_mode="greedy"))(jparams, jc)
    ttoks, _ = trunner.decode_multi(
        tparams, tcfg, tc, torch.tensor([first]), torch.tensor([0]),
        torch.tensor([13]), None, torch.from_numpy(z),
        torch.zeros(1, dtype=torch.int32), torch.ones(1), n_steps=6,
        sample_mode="greedy")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert len(calls) == 6 * 4 * jcfg.num_layers


def test_engine_splitplane_default_and_per_consumer(model, monkeypatch):
    """The default engine stacks the split-plane params (SplitPlaneStacks,
    no residual pair) and serves chunked prefill with piggyback; the
    per-consumer engine (MICROMIX_NO_STACK=1) gives the same greedy tokens
    (the stacked GEMM on a site image equals the quantize and the
    split-plane GEMM on its codes)."""
    jcfg, tcfg, _, tparams = model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (9, 40, 13)]
    new = [8, 6, 5]
    kw = dict(max_seqs=2, page_size=PS, max_pages_per_seq=4, prefill_buckets=(16, 32),
              decode_chunk=4, prefill_chunk=16, seed=0, device="cpu")
    outs = []
    for no_stack in (False, True):
        if no_stack:
            monkeypatch.setenv("MICROMIX_NO_STACK", "1")
        eng = tengine.Engine(tparams, tcfg, **kw)
        reqs = eng.run([tengine.Request(i, p, max_new_tokens=n)
                        for i, (p, n) in enumerate(zip(prompts, new))])
        stacked = isinstance(eng.params["layers"][0].get("qkv_stack"), SplitPlaneStack)
        assert stacked != no_stack
        assert not trunner._can_pair(eng.params, tcfg, 2)
        assert all(r.done and len(r.output) == n for r, n in zip(reqs, new))
        if not no_stack:
            assert eng.phase_steps["mixed"] > 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_quant_linear_takes_codes_and_images(rng):
    """QuantLinear.__call__ with a split-plane weight takes the codes; with
    a ScaledW8 weight a MixedTensor activation is decoded to its image."""
    from micromix_tpu_torch.mx.scaledw8 import pack_scaled_w8
    a = activation_quantize(torch.from_numpy(
        rng.normal(0, 1, (4, 512)).astype(np.float32)), *SPLITS)
    w = torch.from_numpy(rng.normal(0, 0.3, (64, 512)).astype(np.float32))
    sp = QuantLinear(w=quantize_mixed(w, *SPLITS, weight_fp4_only=True, pack_fp4=True))
    w8 = QuantLinear(w=pack_scaled_w8(quantize_mixed(w, *SPLITS, weight_fp4_only=True)))
    assert torch.equal(sp(a), w8(a))
    assert torch.equal(w8(a), w8(dequantize_mixed_device(a)))
