"""Port parity: the Mixtral calibrate -> smooth -> quantize -> perplexity
path (the MoE taps of ``moe_block``, the routed-row masks in
``calib/stats.py``, the expert fan-out of ``calib/smooth.py``) against the
JAX package, on tests/test_golden_pipeline.py's MoE model (hidden 128, 2
layers, 4 experts, top-2, seed 78).

Tolerances:
  * the tapped forward's stats (JAX's attention pointed at its flash
    kernel, as the port's forward runs Kernel E's plain version, and its
    rmsnorm inputs rounded to bf16 where its program states it, by
    ``jax_rounds_bf16`` of tests/jax_rounding.py: without that round an
    expert's below-threshold count parts by 0.54%): absmax
    and saliency within 4%, the below-threshold counts within 0.5%, the
    row totals (which count each expert's routed rows) and the fp6 / fp8
    channel counts equal, as tests/test_torch_calib.py holds the dense
    path;
  * the smoothed weights and norms on the same stats: bit-exact;
  * perplexity: GOLDEN_MOE through the port alone at rtol 2e-3, the
    golden test's.
"""

import numpy as np

import jax.numpy as jnp
import torch

from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.calib import allocate as jalloc
from micromix_tpu.calib import smooth as jsmooth
from micromix_tpu.calib import stats as jstats
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models import transformer as jtr
from micromix_tpu_torch.calib import allocate as talloc
from micromix_tpu_torch.calib import smooth as tsmooth
from micromix_tpu_torch.calib import stats as tstats
from micromix_tpu_torch.eval import datasets as tdata
from micromix_tpu_torch.eval.ppl import eval_ppl
from micromix_tpu_torch.models import hetero as thet
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig

GOLDEN_MOE = {"dense_ppl": 261.7330, "quant_ppl": 263.1772}
CFG = dict(arch="mixtral", vocab_size=256, hidden_size=128,
           intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=32, rope_theta=10000.0, rms_eps=1e-6, num_experts=4,
           num_experts_per_tok=2)


def _golden():
    cfg = ModelConfig(**CFG)
    params = tsurg.random_dense_params(cfg, seed=78, device="cpu")
    stream = tdata.synthetic_tokens(cfg.vocab_size, 1024, seed=78)
    windows = [stream[i * 64:(i + 1) * 64][None, :] for i in range(4)]
    return cfg, params, stream, windows


def _t2np(t):
    return t.to(torch.float32).numpy()


def test_moe_stats_and_smoothing_match_jax(monkeypatch, jax_rounds_bf16):  # noqa: F811
    """The masked per-expert stats of the tapped forward against JAX's,
    then both packages' smoothing (ln2 against the router and every
    expert's w1 and w3) on the port's stats, bit-exact."""
    cfg, tp, _, windows = _golden()
    jcfg = jcommon.ModelConfig(**CFG)
    jp = jsurg.random_dense_params(jcfg, seed=78)
    monkeypatch.setattr(jtr, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    ref = jstats.collect_calibration(jp, jcfg, windows)
    got = tstats.collect_calibration(tp, cfg, windows)
    assert ref.keys() == got.keys()
    assert "layer1/expert3_down_in" in got and "layer1/mlp_in" in got
    for key in ref:
        for f in ("absmax", "saliency"):
            np.testing.assert_allclose(got[key][f], ref[key][f], rtol=0.04,
                                       err_msg=f"{key} {f}")
        for f in ("below4", "below6"):
            np.testing.assert_allclose(got[key][f], ref[key][f], rtol=5e-3,
                                       err_msg=f"{key} {f}")
        np.testing.assert_array_equal(got[key]["total"], ref[key]["total"],
                                      err_msg=key)
    # every token goes to top-2 of 4 experts: the experts' routed rows sum
    # to twice the tokens, each row a hidden-wide sample
    rows = sum(float(got[f"layer0/expert{e}_mlp_in"]["total"])
               for e in range(4)) / cfg.hidden_size
    assert rows == 2 * 4 * 64
    jc = jalloc.stats_to_calibration(ref, jcfg)
    tc = talloc.stats_to_calibration(got, cfg)
    assert [{n: (c.p6_num, c.p8_num) for n, c in lc.items()} for lc in tc] == \
        [{n: (c.p6_num, c.p8_num) for n, c in lc.items()} for lc in jc]

    js = jsmooth.smooth_params(jp, jcfg, got)
    ts = tsmooth.smooth_params(tp, cfg, got)
    for jl, tl in zip(js["layers"], ts["layers"]):
        for n in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                _t2np(tl[n]), np.asarray(jl[n].astype(jnp.float32)), err_msg=n)
        pairs = [(tl["router"], jl["router"])] + [
            (te[n], je[n]) for te, je in zip(tl["experts"], jl["experts"])
            for n in ("w1", "w3", "w2")]
        for t, j in pairs:
            np.testing.assert_array_equal(_t2np(t.w),
                                          np.asarray(j.w.astype(jnp.float32)))


def test_golden_moe_pipeline_port_alone():
    """tests/test_golden_pipeline.py::test_golden_moe_pipeline_numbers
    through the port alone (calibrate, smooth with the expert fan-out,
    quantize, ppl), at its tolerances; and the layer-by-layer
    smooth-and-quantize of the hetero form, whose perplexity stays within
    1% of the segmented form's."""
    cfg, params, stream, windows = _golden()
    stats = tstats.collect_calibration(params, cfg, windows)
    calibs = talloc.stats_to_calibration(stats, cfg)
    qparams = tsurg.quantize_model(tsmooth.smooth_params(params, cfg, stats),
                                   cfg, calibs)
    dense_ppl = eval_ppl(params, cfg, stream[:512], seqlen=128)
    quant_ppl = eval_ppl(qparams, cfg, stream[:512], seqlen=128)
    assert quant_ppl < dense_ppl * 1.25
    np.testing.assert_allclose(dense_ppl, GOLDEN_MOE["dense_ppl"], rtol=2e-3)
    np.testing.assert_allclose(quant_ppl, GOLDEN_MOE["quant_ppl"], rtol=2e-3)
    het = tsmooth.smooth_quantize_model(
        dict(params, layers=list(params["layers"])), cfg, stats, calibs,
        hetero=True)
    assert all("experts" in p and "site_in" in p["experts"][0]
               for p in het["layers"])
    assert len(thet.budgets(het)) > 1
    het_ppl = eval_ppl(het, cfg, stream[:512], seqlen=128)
    assert abs(het_ppl - quant_ppl) / quant_ppl < 0.01, (het_ppl, quant_ppl)
