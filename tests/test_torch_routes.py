"""The prefill routes of the ScaledW8 stacks and grouped experts, and the
engine's refusals on the card, on the CPU.

* Kernels F and I above 64 rows number their 128 x 256 tiles per section
  (``wide_tiles``), so that no tile straddles two sections; their K
  splits (``w8_gemm_split``) divide the 128-deep K steps.
* ``project_all``'s ScaledW8 stacked leg at ``W8_STACK_MAX_M`` rows and
  one row above, and ``moe_block`` (dense dispatch, experts grouped) at
  ``GROUPED_MAX_C`` rows per expert and one above, against the JAX
  package, which runs its XLA route at both (it stops its kernels at 128
  rows).  On the CPU both of the port's routes are the plain f32 product
  rounded once, so the tolerances are those of the other parity tests:
  plain-site outputs within 2^-7 |ref| + 2^-8 max|ref| (exact bf16
  operands, f32 sums in another order, one rounding); rms-site outputs
  within the JAX package's band for a round-half-even tie the row-moment
  sum order moved (rtol 0.05, atol 1.0, median |diff| <= 0.25;
  tests/test_mixed_matmul_kernel.py test_pair_kernel_matches_unfused_chain).
* An ``Engine`` on the card refuses int8 KV pages before it makes a
  cache and accepts a sliding window; on the CPU it serves both.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models import transformer as jtr
from micromix_tpu.models import ModelConfig as JModelConfig
from micromix_tpu.mx import layout as jlay
from micromix_tpu.mx.scaledw8 import ScaledW8 as JScaledW8
from micromix_tpu.mx.scaledw8 import stack_scaled_w8 as j_stack_w8
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.kernels.mixed_matmul import (GROUPED_MAX_C,
                                                     W8_STACK_MAX_M,
                                                     w8_gemm_split, wide_tiles)
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models import transformer as ttr
from micromix_tpu_torch.models.common import (STACK_KERNEL_MAX_M, ModelConfig,
                                              QuantSite, project_all)
from micromix_tpu_torch.mx.mxtensor import quantize_mixed
from micromix_tpu_torch.mx.scaledw8 import pack_scaled_w8, stack_scaled_w8
from micromix_tpu_torch.serve import engine as tengine

# the module (the package exports a function of the same name)
mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")

K4, K6, K8 = 256, 128, 128
K = K4 + K6 + K8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _assert_gemm_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))


def _assert_pair_band(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=1.0)
    assert np.median(np.abs(got - ref)) <= 0.25


SECTION_SETS = [(8,), (256,), (264,), (4096, 1024, 1024), (14336, 14336),
                (256, 64, 64), (384, 120), (200, 120), (12104, 8136)]


@pytest.mark.parametrize("sections", SECTION_SETS)
def test_wide_tiles_number_each_section(sections):
    """Section i owns ceil(rows_i / 256) tiles from t[i] on; the tiles of a
    section start inside it and together cover its rows, so a block that
    reads rows up to its section's true rows never reads a neighbour."""
    t = wide_tiles(sections)
    assert len(t) == len(sections) + 1 and t[0] == 0
    bn = mm._BN_WIDE
    for i, n in enumerate(sections):
        count = t[i + 1] - t[i]
        assert count == -(-n // bn)
        starts = [j * bn for j in range(count)]
        assert all(s < n for s in starts)
        assert starts[-1] + bn >= n
    if sections == (4096, 1024, 1024):
        assert t == (0, 16, 20, 24)


@pytest.mark.parametrize("m", [65, 100, 128, 129, 256, 300, 512, 1023])
@pytest.mark.parametrize("sections,k", [((4096, 1024, 1024), 4096),
                                        ((14336, 14336), 4096),
                                        ((4096,), 14336),
                                        ((256, 64, 64), 512),
                                        ((12104, 8136), 512)])
def test_wide_splits_divide_the_steps(m, sections, k):
    """F's split (its whole stack as one weight) and I's (Kernel B's split
    of one expert's first section, which keeps I equal to the per-expert
    loop) each divide the 128-deep K steps, at most 16."""
    total = sum(-(-n // 64) * 64 for n in sections)
    steps = k // 128
    for d in (w8_gemm_split(m, total, k), w8_gemm_split(m, sections[0], k)):
        assert 1 <= d <= 16 and steps % d == 0


def test_route_limits():
    """The ScaledW8 stack and grouped limits are measured on the card and
    never below the JAX package's 128; split-plane stacks and the residual
    pair keep 128."""
    assert W8_STACK_MAX_M >= 128 and GROUPED_MAX_C >= 128
    assert STACK_KERNEL_MAX_M == 128
    assert W8_STACK_MAX_M < mm.W8_PREFILL_DEQUANT_THRESHOLD


def _w8(rng, n, k=K):
    """One random weight as a JAX and a port ScaledW8, made by the port's
    quantizer (whose codes equal the JAX package's: tests/test_torch_model.py;
    the JAX quantizer's eager compiles would cost tens of seconds)."""
    tw = pack_scaled_w8(quantize_mixed(
        torch.from_numpy(rng.normal(0, 0.3, (n, k)).astype(np.float32)),
        K4, K6, K8, weight_fp4_only=True))
    jw = JScaledW8(codes=jnp.asarray(tw.codes.numpy()),
                   base=jnp.full((1, 1), tw.base, jnp.int32), k4=K4, k6=K6, k8=K8)
    return jw, tw


@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("producer", ["plain", "rms"])
def test_project_all_stack_at_the_route_limit(above, producer):
    """project_all's ScaledW8 stacked leg at ``W8_STACK_MAX_M`` rows (the
    stacked GEMM's plain version) and one row above (the dequantized
    stack), against the JAX package's stacked project_all."""
    rng = np.random.default_rng(7 + above)
    m = W8_STACK_MAX_M + above
    ns = (256, 120, 128)
    pairs = [_w8(rng, n) for n in ns]
    jst, tst = j_stack_w8([p[0] for p in pairs]), stack_scaled_w8([p[1] for p in pairs])
    perm = jlay.compose_segmented(rng.permutation(K).astype(np.int32), K4, K6, K8)
    jsite = jcommon.QuantSite(K4, K6, K8, perm=jnp.asarray(perm))
    tsite = QuantSite(K4, K6, K8, perm=torch.from_numpy(perm))
    jx, tx = _bf16_pair(rng.normal(0, 1, (m, K)).astype(np.float32))
    jg = tg = None
    if producer == "rms":
        jg, tg = _bf16_pair(rng.normal(1, 0.1, (K,)).astype(np.float32))
    ref = jax.jit(lambda x, g: jcommon.project_all(x, jsite, None, g, 1e-5,
                                                   stack=jst))(jx, jg)
    got = project_all(tx, tsite, None, tg, 1e-5, stack=tst)
    for g, r in zip(got, ref):
        assert g.shape == (m, r.shape[-1])
        if producer == "plain":
            _assert_gemm_close(_f32(g), _f32(r))
        else:
            _assert_pair_band(_f32(g), _f32(r))


def _mixtral_cfg():
    jcfg = JModelConfig(arch="mixtral", vocab_size=256, hidden_size=256,
                        intermediate_size=512, num_layers=1, num_heads=4,
                        num_kv_heads=2, head_dim=64, rope_theta=1e6,
                        rms_eps=1e-5, num_experts=4, num_experts_per_tok=2)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def mixtral_layer():
    jcfg, tcfg = _mixtral_cfg()
    jq = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, p6=64, p8=64, seed=1), host=True)
    tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    return jcfg, tcfg, jq, tsurg.stack_layer_projections(tq)


@pytest.mark.parametrize("above", [0, 1])
def test_moe_block_at_the_grouped_limit(mixtral_layer, above):
    """moe_block under dense dispatch, experts grouped, with
    ``GROUPED_MAX_C`` tokens (every expert's rows: the grouped GEMM's
    plain version) and one more (the dequantized batched product), against
    the JAX moe_block on the converted parameters."""
    jcfg, tcfg, jq, tg = mixtral_layer
    t = GROUPED_MAX_C + above
    jx, tx = _bf16_pair(np.random.default_rng(t).normal(
        0, 1, (1, t, 256)).astype(np.float32))
    ref = _f32(jax.jit(lambda h, p: jtr.moe_block(h, p, jcfg))(jx, jq["layers"][0]))
    got = _f32(ttr.moe_block(tx, tg["layers"][0], tcfg))
    assert got.shape == ref.shape == (1, t, 256)
    _assert_gemm_close(got, ref)


def _tiny_llama(**kw):
    base = dict(arch="llama", vocab_size=128, hidden_size=512,
                intermediate_size=512, num_layers=1, num_heads=4,
                num_kv_heads=2, head_dim=128, rope_theta=1e4, rms_eps=1e-5)
    base.update(kw)
    return ModelConfig(**base)


@pytest.mark.parametrize("kv_bits,window", [(8, None), (4, 64), (16, None)])
def test_engine_refuses_what_the_card_cannot_serve(kv_bits, window):
    """The check the engine runs before it makes a cache: on a CUDA
    device, KV pages of other than 4 or 8 bits (bf16 pages) raise
    NotImplementedError naming ROADMAP 2b, while int8 pages and a sliding
    window over int4 pages pass (Kernels C, D and H read int8 pages; C, E
    and H apply the window); the CPU passes all; int4 pages without a
    window pass on both."""
    cfg = _tiny_llama(sliding_window=window)
    if kv_bits in (4, 8):
        tengine.check_card_serves(torch.device("cuda"), cfg, kv_bits)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP 2b"):
            tengine.check_card_serves(torch.device("cuda"), cfg, kv_bits)
    tengine.check_card_serves(torch.device("cpu"), cfg, kv_bits)
    tengine.check_card_serves(torch.device("cuda"), _tiny_llama(), 4)


@pytest.mark.parametrize("kv_bits,window", [(8, None), (4, 64)])
def test_engine_serves_them_on_the_cpu(kv_bits, window):
    """On the CPU the plain versions serve int8 pages and a window: a
    short greedy request runs to its token count."""
    cfg = _tiny_llama(sliding_window=window)
    params = tsurg.random_quantized_model(
        cfg, tsurg.default_calibration(cfg, p6=128, p8=128, seed=0), seed=0,
        device="cpu")
    eng = tengine.Engine(params, cfg, max_seqs=2, page_size=16,
                         max_pages_per_seq=8, kv_bits=kv_bits,
                         prefill_buckets=(16, 32, 64, 128), decode_chunk=4,
                         device="cpu")
    reqs = eng.run([tengine.Request(0, list(range(3, 83)), max_new_tokens=6)])
    assert reqs[0].done and len(reqs[0].output) == 6
    assert all(0 <= t < cfg.vocab_size for t in reqs[0].output)
