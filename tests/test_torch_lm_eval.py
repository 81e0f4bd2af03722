"""Port parity: the lm-eval adapter (``eval/lm_eval_adapter.py``) and
``cli eval --tasks``.

* ``Scorer``: JAX's and the port's on the same quantized Llama (the
  golden pipeline's model of ``tests/test_torch_calib.py``, quantized by
  JAX from the port's calibration statistics and converted), with and
  without 4-bit KV fake quantization: continuation log-likelihoods (one
  request cut to ``max_len``), a rolling log-likelihood over three windows
  and greedy generation with and without stop ids.  JAX's attention is
  pointed at its flash kernel (interpret mode), as the port's forward runs
  Kernel E's plain version: JAX's CPU XLA attention rounds the
  probabilities to bf16, which moved a log-likelihood by 0.28%.
  Tolerance: rtol 2e-3 on the log-likelihoods (the perplexity parity
  test's); greedy flags and generated tokens equal.
* ``run_lm_eval`` under a stand-in for lm-eval 0.4's ``LM`` /
  ``Instance`` / ``simple_evaluate`` (the JAX package's own
  ``tests/test_lm_eval_harness.py`` harness): the port's ``results``
  equal JAX's on the same converted model, and equal again on a second
  run.
* ``cli eval --tasks`` runs on the CPU under the stand-in and writes the
  harness's results under ``results["lm_eval"]``, equal to
  ``run_lm_eval`` on the same dense model (the stand-in tokenizer decodes
  ids past its eight words as ``<id>``).
"""

import json
import sys

import numpy as np
import pytest

import jax

from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_cli import ckpt  # noqa: F401 (fixture: the WordLevel checkpoint)
from test_lm_eval_harness import _install_mini_lm_eval, _WordTokenizer
from test_torch_calib import CFG

from micromix_tpu.calib import allocate as jalloc
from micromix_tpu.eval import lm_eval_adapter as jadapter
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models import transformer as jtr
from micromix_tpu_torch.calib import stats as tstats
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.eval import datasets as tdata
from micromix_tpu_torch.eval import lm_eval_adapter as tadapter
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models import surgery as tsurg

RTOL = 2e-3


class _Tokenizer(_WordTokenizer):
    """The harness test's tokenizer; ids past its words decode as <id>."""

    def decode(self, ids):
        return " ".join(self.inv.get(int(i), f"<{int(i)}>") for i in ids)


@pytest.fixture
def mini_harness():
    """lm-eval's modules replaced by the stand-in for one test."""
    names = ("lm_eval", "lm_eval.api", "lm_eval.api.model")
    saved = {k: sys.modules.get(k) for k in names}
    _install_mini_lm_eval()
    yield
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


@pytest.fixture(scope="module")
def quantized():
    """The golden model quantized by JAX from the port's statistics, in
    both packages."""
    jcfg, tcfg = jcommon.ModelConfig(**CFG), ModelConfig(**CFG)
    stream = tdata.synthetic_tokens(tcfg.vocab_size, 2048, seed=77)
    windows = [stream[i * 64:(i + 1) * 64][None, :] for i in range(4)]
    stats = tstats.collect_calibration(
        tsurg.random_dense_params(tcfg, seed=77, device="cpu"), tcfg, windows)
    jq = jsurg.quantize_model(jsurg.random_dense_params(jcfg, seed=77), jcfg,
                              jalloc.stats_to_calibration(stats, jcfg),
                              host=True)
    tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    return jcfg, tcfg, jq, tq, stream


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_scorer_matches_jax(quantized, kv_bits, monkeypatch):
    monkeypatch.setattr(jtr, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    jcfg, tcfg, jq, tq, stream = quantized
    max_len = 48
    scorers = (jadapter.Scorer(jq, jcfg, max_len=max_len, kv_quant_bits=kv_bits),
               tadapter.Scorer(tq, tcfg, max_len=max_len, kv_quant_bits=kv_bits))
    toks = [int(t) for t in stream[100:300]]
    requests = ((toks[:20], toks[20:23]),        # a 3-token continuation
                (toks[30:90], toks[90:92]),      # 62 tokens, cut to 48
                (toks[:5], toks[5:6]))
    for ctx, cont in requests:
        (jll, jg), (tll, tg) = (s.loglikelihood_tokens(ctx, cont)
                                for s in scorers)
        assert isinstance(tll, float) and isinstance(tg, bool)
        np.testing.assert_allclose(tll, jll, rtol=RTOL)
        assert tg == jg
    # 100 tokens: windows of 48 from 0, 47 and 94
    jr, tr = (s.rolling_loglikelihood(toks[100:200]) for s in scorers)
    np.testing.assert_allclose(tr, jr, rtol=RTOL)
    jgen, tgen = (s.greedy_generate(toks[:10], 4) for s in scorers)
    assert tgen == jgen and len(tgen) == 4
    stop = [jgen[1]]
    jgen, tgen = (s.greedy_generate(toks[:10], 4, stop_ids=stop)
                  for s in scorers)
    assert tgen == jgen and tgen[-1] == stop[0] and len(tgen) <= 2


def test_run_lm_eval_matches_jax(mini_harness):
    """The JAX package's harness test's model (vocab 8, one layer,
    all-MXFP4), converted to the port."""
    cfg = dict(arch="llama", vocab_size=8, hidden_size=64,
               intermediate_size=128, num_layers=1, num_heads=2,
               num_kv_heads=2, head_dim=32, rope_theta=10000.0, rms_eps=1e-6)
    jcfg, tcfg = jcommon.ModelConfig(**cfg), ModelConfig(**cfg)
    jq = jsurg.quantize_model(jsurg.random_dense_params(jcfg, seed=60), jcfg,
                              jsurg.default_calibration(jcfg, p6=0, p8=0))
    tq = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    tok = _WordTokenizer()
    want = jadapter.run_lm_eval(jadapter.Scorer(jq, jcfg, max_len=32), tok,
                                ["synthetic_mc"])
    scorer = tadapter.Scorer(tq, tcfg, max_len=32)
    got = tadapter.run_lm_eval(scorer, tok, ["synthetic_mc"])
    assert got["results"] == want["results"]
    assert 0.0 <= got["results"]["synthetic_mc"]["acc"] <= 1.0
    assert tadapter.run_lm_eval(scorer, tok, ["synthetic_mc"]) == got
    lm = tadapter.make_lm_eval_model(scorer, tok)
    assert isinstance(lm, sys.modules["lm_eval.api.model"].LM)


def test_cli_eval_tasks(ckpt, tmp_path, capsys, monkeypatch,  # noqa: F811
                        mini_harness):
    """``eval --tasks`` on the dense checkpoint (the stand-in tokenizer in
    place of the checkpoint's): the printed and logged results equal
    ``run_lm_eval`` over the dense model the loader reads."""
    from micromix_tpu_torch import cli
    from micromix_tpu_torch.models.loader import config_from_hf, load_dense_params
    monkeypatch.setattr(cli, "_tokenizer", lambda args: _Tokenizer())
    logs = tmp_path / "results"
    cli.main(["--platform", "cpu", "eval", "--model", ckpt, "--tasks",
              "synthetic_mc", "--limit", "2", "--seqlen", "32",
              "--log-dir", str(logs)])
    out = capsys.readouterr().out
    (log,) = logs.iterdir()
    with open(log) as f:
        got = json.load(f)["lm_eval"]
    with open(f"{ckpt}/config.json") as f:
        cfg = config_from_hf(json.load(f))
    scorer = tadapter.Scorer(load_dense_params(ckpt, cfg, device="cpu"), cfg,
                             max_len=32)
    want = tadapter.run_lm_eval(scorer, _Tokenizer(), ["synthetic_mc"],
                                limit=2)["results"]
    assert got == want and json.loads(out) == want
    assert "not ported" not in out
