"""Port parity: the dense calibrate -> smooth -> quantize -> perplexity
path (``micromix_tpu_torch.calib``, ``.eval``, the dense forward's taps and
``kv_quant_bits``) against the JAX package, on the golden pipeline's
model (``tests/test_golden_pipeline.py``: hidden 128, 2 layers, vocab 256,
seed 77).

Tolerances:
  * bit-exact on the same inputs: ``quantize_int_group`` (against the
    jitted JAX function, which folds ``/ qmax`` into a reciprocal
    multiply), ``_update_site``, ``allocate_site`` /
    ``stats_to_calibration`` / ``average_bits``, ``smooth_params`` (no
    bf16 flip), the artifacts' keys and values;
  * whole-pipeline stats (JAX's forward pointed at its flash kernel):
    absmax and saliency within 4% (the dense linears' f32 sums run in
    another order, so an output can land one bf16 step (0.8%) apart, and
    the step compounds through silu * up), the below-threshold counts
    within 0.5%; the fp6 / fp8 channel counts equal;
  * perplexity: rtol 2e-3, the golden test's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.calib import allocate as jalloc
from micromix_tpu.calib import artifacts as jart
from micromix_tpu.calib import smooth as jsmooth
from micromix_tpu.calib import stats as jstats
from micromix_tpu.eval import datasets as jdata
from micromix_tpu.eval.ppl import eval_ppl as j_eval_ppl
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models import transformer as jtr
from micromix_tpu_torch.calib import allocate as talloc
from micromix_tpu_torch.calib import artifacts as tart
from micromix_tpu_torch.calib import smooth as tsmooth
from micromix_tpu_torch.calib import stats as tstats
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.eval import datasets as tdata
from micromix_tpu_torch.eval.ppl import eval_ppl as t_eval_ppl
from micromix_tpu_torch.models import common as tcommon
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig

GOLDEN = {"dense_ppl": 260.6976, "quant_ppl": 260.1685, "avg_bits": 7.6}
CFG = dict(arch="llama", vocab_size=256, hidden_size=128,
           intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=32, rope_theta=10000.0, rms_eps=1e-6)


@pytest.fixture(scope="module")
def golden():
    """The golden model in both packages, its stream, its four 64-token
    calibration windows and the port's stats."""
    jcfg = jcommon.ModelConfig(**CFG)
    tcfg = ModelConfig(**CFG)
    jp = jsurg.random_dense_params(jcfg, seed=77)
    tp = tsurg.random_dense_params(tcfg, seed=77, device="cpu")
    stream = tdata.synthetic_tokens(tcfg.vocab_size, 2048, seed=77)
    windows = [stream[i * 64:(i + 1) * 64][None, :] for i in range(4)]
    stats = tstats.collect_calibration(tp, tcfg, windows)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, stream=stream,
                windows=windows, stats=stats)


def _t2np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("bits,group", [(4, 32), (8, 32), (4, 128)])
def test_quantize_int_group_matches_jitted_jax(bits, group):
    rng = np.random.default_rng(bits + group)
    x = jnp.asarray(rng.normal(0, 1, (48, 4, group)) * rng.gamma(1, 1, (4, 1)),
                    jnp.bfloat16)
    ref = jax.jit(lambda a: jcommon.quantize_int_group(a, bits, group))(x)
    got = tcommon.quantize_int_group(
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
        bits, group)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_t2np(got), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("masked", [False, True])
def test_update_site_bit_exact(masked):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(0, 1, (2, 96, 256)) * rng.gamma(1, 1, 256),
                    jnp.bfloat16)
    mask = rng.random((2, 96)) < 0.5 if masked else None
    acc = {k: np.asarray(v) + 0.25 for k, v in jstats.init_stats(256).items()}
    ref = jax.jit(lambda a, x, m: jstats._update_site(a, x, 0.9, m))(
        acc, x, None if mask is None else jnp.asarray(mask))
    got = tstats._update_site(
        {k: torch.as_tensor(v) for k, v in acc.items()},
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
        0.9, None if mask is None else torch.from_numpy(mask))
    for k in ("absmax", "below4", "below6", "total"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # the channel mean is an f32 sum of 192 rows; XLA's CPU reduction of
    # the unmasked rows runs in another order than torch's (192 * 2^-24
    # bounds the difference)
    np.testing.assert_allclose(got["saliency"].numpy(),
                               np.asarray(ref["saliency"]), rtol=192 * 2.0 ** -24)


def test_allocation_from_identical_stats(golden):
    """The same stats (the port's, plus an empty site and a ratio just
    across a multiple of 128) give the same SiteCalibrations and bits."""
    stats = dict(golden["stats"])
    k = golden["tcfg"].intermediate_size
    stats["layer1/down_in"] = dict(stats["layer1/down_in"], total=np.float32(0))
    stats["layer0/down_in"] = dict(stats["layer0/down_in"],
                                   below4=np.float32(1000.0 * 129 / k),
                                   below6=np.float32(1000.0 * 129 / k),
                                   total=np.float32(1000.0))
    jc = jalloc.stats_to_calibration(stats, golden["jcfg"])
    tc = talloc.stats_to_calibration(stats, golden["tcfg"])
    for jl, tl in zip(jc, tc):
        assert jl.keys() == tl.keys()
        for name in jl:
            assert (tl[name].p6_num, tl[name].p8_num) == \
                (jl[name].p6_num, jl[name].p8_num), name
            np.testing.assert_array_equal(tl[name].reorder_index,
                                          jl[name].reorder_index)
    assert tc[1]["down_in"].p8_num == k
    assert talloc.average_bits(tc, golden["tcfg"]) == \
        jalloc.average_bits(jc, golden["jcfg"])


def test_smooth_params_bit_exact(golden):
    """No bf16 flip: the port's ``act ** 0.5`` (a square root) and JAX's
    power give the same scales here."""
    ref = jsmooth.smooth_params(golden["jp"], golden["jcfg"], golden["stats"])
    got = tsmooth.smooth_params(golden["tp"], golden["tcfg"], golden["stats"])
    for jl, tl in zip(ref["layers"], got["layers"]):
        for n in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                _t2np(tl[n]), np.asarray(jl[n].astype(jnp.float32)), err_msg=n)
        for n in ("q", "k", "v", "gate", "up", "o", "down"):
            np.testing.assert_array_equal(
                _t2np(tl[n].w), np.asarray(jl[n].w.astype(jnp.float32)),
                err_msg=n)


def test_layerwise_smooth_quantize_equals_whole_tree(golden):
    tcfg = golden["tcfg"]
    calibs = talloc.stats_to_calibration(golden["stats"], tcfg)
    whole = tsurg.quantize_model(
        tsmooth.smooth_params(golden["tp"], tcfg, golden["stats"]), tcfg, calibs)
    dense = dict(golden["tp"], layers=list(golden["tp"]["layers"]))
    layerwise = tsmooth.smooth_quantize_model(dense, tcfg, golden["stats"],
                                              calibs)
    assert dense["layers"] == [None] * tcfg.num_layers
    for wl, ll in zip(whole["layers"], layerwise["layers"]):
        assert wl.keys() == ll.keys()
        for n in ("q", "k", "v", "o", "gate", "up", "down"):
            assert torch.equal(wl[n].w.codes, ll[n].w.codes), n
            assert wl[n].w.base == ll[n].w.base
        for n in ("ln1", "ln2"):
            assert torch.equal(wl[n], ll[n])
        for n in ("attn_site", "o_site", "mlp_site"):
            assert torch.equal(wl[n].perm, ll[n].perm)


def test_artifacts_load_in_either_package(golden, tmp_path):
    tcfg = golden["tcfg"]
    stats = golden["stats"]
    calibs = talloc.stats_to_calibration(stats, tcfg)
    for save, load in ((jart.save_calibration, tart.load_calibration),
                       (tart.save_calibration, jart.load_calibration)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, calibs, stats)
        got, absmax = load(path)
        assert sorted(absmax) == sorted(stats)
        for key in stats:
            np.testing.assert_array_equal(absmax[key], stats[key]["absmax"])
        for cl, gl in zip(calibs, got):
            assert cl.keys() == gl.keys()
            for n in cl:
                assert (gl[n].p6_num, gl[n].p8_num) == (cl[n].p6_num, cl[n].p8_num)
                np.testing.assert_array_equal(gl[n].reorder_index,
                                              cl[n].reorder_index)


def test_pipeline_stats_against_jax(golden, monkeypatch):
    """The tapped forward sees the same site inputs: JAX's calibration
    (its attention pointed at its flash kernel, as the port's forward
    uses Kernel E's plain version) against the port's."""
    monkeypatch.setattr(jtr, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    ref = jstats.collect_calibration(golden["jp"], golden["jcfg"],
                                     golden["windows"])
    got = golden["stats"]
    assert ref.keys() == got.keys()
    for key in ref:
        for f in ("absmax", "saliency"):
            np.testing.assert_allclose(got[key][f], ref[key][f], rtol=0.04,
                                       err_msg=f"{key} {f}")
        for f in ("below4", "below6"):
            np.testing.assert_allclose(got[key][f], ref[key][f], rtol=5e-3,
                                       err_msg=f"{key} {f}")
        np.testing.assert_array_equal(got[key]["total"], ref[key]["total"])
    np.testing.assert_array_equal(got["layer0/attn_in"]["absmax"],
                                  ref["layer0/attn_in"]["absmax"])
    jc = jalloc.stats_to_calibration(ref, golden["jcfg"])
    tc = talloc.stats_to_calibration(got, golden["tcfg"])
    assert [{n: (c.p6_num, c.p8_num) for n, c in lc.items()} for lc in tc] == \
        [{n: (c.p6_num, c.p8_num) for n, c in lc.items()} for lc in jc]


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_eval_ppl_matches_jax(golden, kv_bits):
    """Dense eval (JAX's XLA attention, as the golden run) and, without
    KV quantization, the quantized eval of JAX's own quantized model
    converted to the port: rtol 2e-3."""
    stream = golden["stream"][:512]
    ref = j_eval_ppl(golden["jp"], golden["jcfg"], stream, seqlen=128,
                     kv_quant_bits=kv_bits)
    got = t_eval_ppl(golden["tp"], golden["tcfg"], stream, seqlen=128,
                     kv_quant_bits=kv_bits)
    np.testing.assert_allclose(got, ref, rtol=2e-3)
    if kv_bits is None:
        jcfg, tcfg = golden["jcfg"], golden["tcfg"]
        jq = jsurg.quantize_model(
            jsurg.random_dense_params(jcfg, seed=77), jcfg,
            jalloc.stats_to_calibration(golden["stats"], jcfg), host=True)
        tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
        np.testing.assert_allclose(
            t_eval_ppl(tq, tcfg, stream, seqlen=128),
            j_eval_ppl(jq, jcfg, stream, seqlen=128), rtol=2e-3)


def test_golden_pipeline_port_alone(golden):
    """``tests/test_golden_pipeline.py`` through the port alone, at its
    tolerances."""
    tcfg, stats, stream = golden["tcfg"], golden["stats"], golden["stream"]
    calibs = talloc.stats_to_calibration(stats, tcfg)
    bits = talloc.average_bits(calibs, tcfg)
    qparams = tsurg.quantize_model(
        tsmooth.smooth_params(golden["tp"], tcfg, stats, alpha=0.5), tcfg,
        calibs)
    dense_ppl = t_eval_ppl(golden["tp"], tcfg, stream[:512], seqlen=128)
    quant_ppl = t_eval_ppl(qparams, tcfg, stream[:512], seqlen=128)
    assert quant_ppl < dense_ppl * 1.25
    np.testing.assert_allclose(bits, GOLDEN["avg_bits"], rtol=1e-6)
    np.testing.assert_allclose(dense_ppl, GOLDEN["dense_ppl"], rtol=2e-3)
    np.testing.assert_allclose(quant_ppl, GOLDEN["quant_ppl"], rtol=2e-3)


def test_moe_calibration_is_refused():
    cfg = ModelConfig(**dict(CFG, arch="mixtral", num_experts=4,
                             num_experts_per_tok=2))
    with pytest.raises(NotImplementedError, match="ROADMAP 1.8"):
        tstats.collect_calibration({"embed": torch.zeros(1)}, cfg, [])


class _ToyTokenizer:
    """HF-tokenizer stand-in: whitespace words hashed by their bytes."""

    vocab_size = 97

    def __call__(self, text, return_tensors="np"):
        ids = [sum(w.encode()) % self.vocab_size for w in text.split()]
        return {"input_ids": np.asarray([ids], np.int64)}


def test_loaders_match_jax():
    np.testing.assert_array_equal(tdata.synthetic_tokens(1000, 3000, seed=5),
                                  jdata.synthetic_tokens(1000, 3000, seed=5))
    tok = _ToyTokenizer()
    for name in ("synthetic", "file:tests/data/bpe_corpus.txt"):
        jc, jt = jdata.get_loaders(name, tok, seqlen=32, nsamples=3, seed=2)
        tc, tt = tdata.get_loaders(name, tok, seqlen=32, nsamples=3, seed=2)
        np.testing.assert_array_equal(tt, jt)
        assert len(tc) == len(jc) == 3
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)
    for hub in ("wikitext2", "ptb", "c4"):
        with pytest.raises(RuntimeError, match="'synthetic' or 'file:"):
            tdata.get_loaders(hub, tok)
    with pytest.raises(ValueError):
        tdata.get_loaders("nope", tok)
