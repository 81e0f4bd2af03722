"""Port parity: the budgets-as-data (hetero) form (``models/hetero.py``
and Kernel A's block-format route) against the JAX package on the CPU.

* Site images: the port's ``fakequant_site`` / ``rmsnorm_fakequant`` and
  ``fakequant_site_blocks``'s silu producer (plain versions) against the
  JAX package's ``fakequant_site`` / ``rmsnorm_fakequant`` / the silu
  site of its down projection, with block formats drawn per 32-block.
* A hetero Llama and a hetero Mixtral (hidden 128, 2 layers): codes,
  bases, perms and ``block_fmt`` bit-exact, the full forward's logits,
  and the engine's greedy tokens.
* The port alone: the hetero form within 1% of the segmented form's
  perplexity (tests/test_golden_pipeline.py's rule).

Tolerances:
  * plain-site images and the quantized trees: bit-exact (==);
  * rms and silu images: the row moment's sum order, 1 / sqrt (the port,
    correctly rounded) against XLA's ``rsqrt`` (which differs in the last
    bit for 29% of inputs) and the sigmoid's last bit can move a
    round-half-even tie, so at most 1 in 1000 elements may differ, each by
    one grid step of its 32-block;
  * forward logits: within 2% of max |logit|, argmax equal at every
    position (measured 0.34% on the Llama).

The JAX package's CPU XLA keeps a residual sum (``h + o``, a bf16 add in
its program) in f32 into the hetero rms site when the two fuse, skipping
the bf16 round its program states; with that round skipped, 13 of 1792
elements of the first MLP site's image move, and the
greedy paths part.  The model test takes ``jax_rounds_bf16``
(tests/jax_rounding.py), which puts an optimization barrier on the site's
input, so JAX's reference rounds where its program says.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_checkpoint import _assert_port_trees_equal

from micromix_tpu.models import common as jcommon
from micromix_tpu.models import hetero as jhet
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models import transformer as jtr
from micromix_tpu.serve import engine as jengine
from micromix_tpu_torch.calib import allocate as talloc
from micromix_tpu_torch.calib import stats as tstats
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.eval import datasets as tdata
from micromix_tpu_torch.eval.ppl import eval_ppl
from micromix_tpu_torch.kernels.fakequant import fakequant_site_blocks
from micromix_tpu_torch.models import hetero as thet
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models.transformer import forward
from micromix_tpu_torch.serve import engine as tengine

CFG = dict(arch="llama", vocab_size=256, hidden_size=128,
           intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=32, rope_theta=10000.0, rms_eps=1e-6)
MODELS = {"llama": CFG,
          "mixtral": dict(CFG, arch="mixtral", num_experts=4,
                          num_experts_per_tok=2)}
MANTISSA = (1, 2, 3)   # fp4, fp6, fp8


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _assert_block_tie_band(got, ref, fmt):
    """At most 1/1000 of the elements differ, each by one grid step of its
    canonical 32-block in that block's format."""
    diff = got != ref
    assert diff.mean() <= 1e-3, f"{int(diff.sum())} of {diff.size} differ"
    g = got.reshape(got.shape[0], -1, 32)
    r = ref.reshape(ref.shape[0], -1, 32)
    bmax = np.maximum(np.abs(g).max(axis=-1), np.abs(r).max(axis=-1))
    mant = np.asarray(MANTISSA)[fmt][None, :]
    step = np.exp2(np.floor(np.log2(np.maximum(bmax, 1e-30))) - mant)
    assert (np.abs(g - r) <= step[..., None]).all()


def test_hetero_site_images_match_jax():
    """M = 16, K = 1024: a plain site with a perm (bit-exact), an rms
    site with a perm and gamma, a silu site without perm (tie band); the
    block formats drawn per block, so runs of every length."""
    rng = np.random.default_rng(3)
    m, k = 16, 1024
    fmt = rng.integers(0, 3, k // 32).astype(np.int32)
    perm = rng.permutation(k).astype(np.int32)
    jsite = jhet.FakeQuantSite(perm=jnp.asarray(perm), block_fmt=jnp.asarray(fmt))
    jdown = jhet.FakeQuantSite(perm=None, block_fmt=jnp.asarray(fmt))
    tfmt, tperm = torch.from_numpy(fmt), torch.from_numpy(perm)
    xj, xt = _bf16_pair(rng.normal(0, 1, (m, k)))
    gamma = (1.0 + 0.1 * rng.normal(size=k)).astype(np.float32)
    gj, gt = _bf16_pair(gamma)

    tsite = thet.FakeQuantSite(perm=tperm, block_fmt=tfmt)
    plain = jax.jit(lambda x: jhet.fakequant_site(x, jsite))(xj)
    np.testing.assert_array_equal(_f32(thet.fakequant_site(xt, tsite)), _f32(plain))

    rms = jax.jit(lambda x, g: jhet.rmsnorm_fakequant(x, g, jsite, 1e-6))(xj, gj)
    got = thet.rmsnorm_fakequant(xt, gt, tsite, 1e-6)
    _assert_block_tie_band(_f32(got), _f32(rms), fmt)

    uj, ut = _bf16_pair(rng.normal(0, 1, (m, k)))
    silu = jax.jit(lambda g, u: jhet.fakequant_site(
        jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32), jdown))(xj, uj)
    got = fakequant_site_blocks(xt, tfmt, producer="silu", up=ut)
    _assert_block_tie_band(_f32(got), _f32(silu), fmt)


def test_hetero_models_match_jax(jax_rounds_bf16):  # noqa: F811
    """For a hetero Llama and a hetero Mixtral (budgets from a seeded
    calibration with 32-wide fp6 and fp8 segments): the quantized trees
    bit-exact, the forward's logits within 2% of the range with argmax
    equal, and four greedy requests over two slots through both engines
    equal."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 14, 6, 11)]
    new = [6, 5, 7, 4]
    kw = dict(max_seqs=2, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16,), decode_chunk=4, seed=0)
    toks = rng.integers(0, 256, (1, 14)).astype(np.int32)
    for name, base in MODELS.items():
        jcfg, tcfg = jcommon.ModelConfig(**base), ModelConfig(**base)
        jq = jhet.quantize_model_hetero(
            jsurg.random_dense_params(jcfg, seed=5), jcfg,
            jsurg.default_calibration(jcfg, p6=32, p8=32, seed=5))
        tq = thet.quantize_model_hetero(
            tsurg.random_dense_params(tcfg, seed=5, device="cpu"), tcfg,
            tsurg.default_calibration(tcfg, p6=32, p8=32, seed=5))
        _assert_port_trees_equal(
            tq, from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu"))
        assert thet.budgets(tq) == {(64, 32, 32)}

        jl = np.asarray(jax.jit(lambda p, t: jtr.forward(
            p, jcfg, t, use_flash=True))(jq, jnp.asarray(toks)))
        with torch.inference_mode():
            tl = forward(tq, tcfg, torch.from_numpy(toks)).numpy()
        assert np.abs(tl - jl).max() <= 0.02 * np.abs(jl).max(), name
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))

        jreqs = jengine.Engine(jq, jcfg, piggyback=False, **kw).run(
            [jengine.Request(i, p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new))])
        treqs = [tengine.Request(i, p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, new))]
        tengine.Engine(tq, tcfg, device="cpu", **kw).run(treqs)
        for jr, tr, n in zip(jreqs, treqs, new):
            assert tr.done and len(tr.output) == n
            assert tr.output == jr.output, (name, tr.output, jr.output)


def test_hetero_ppl_tracks_segmented():
    """tests/test_golden_pipeline.py::test_hetero_representation_tracks_segmented
    through the port alone: the golden Llama calibrated by the port, then
    quantized segmented and hetero; the two perplexities within 1%."""
    cfg = ModelConfig(**dict(CFG, intermediate_size=256))
    params = tsurg.random_dense_params(cfg, seed=77, device="cpu")
    stream = tdata.synthetic_tokens(cfg.vocab_size, 1024, seed=77)
    windows = [stream[i * 64:(i + 1) * 64][None, :] for i in range(4)]
    calibs = talloc.stats_to_calibration(
        tstats.collect_calibration(params, cfg, windows), cfg)
    seg = tsurg.quantize_model(params, cfg, calibs)
    het = thet.quantize_model_hetero(params, cfg, calibs)
    assert len(thet.budgets(het)) > 1
    ppl_seg = eval_ppl(seg, cfg, stream[:512], seqlen=128)
    ppl_het = eval_ppl(het, cfg, stream[:512], seqlen=128)
    assert abs(ppl_seg - ppl_het) / ppl_seg < 0.01, (ppl_seg, ppl_het)
