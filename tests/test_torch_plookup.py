"""Port parity for prompt-lookup (n-gram) speculative decoding: the
proposal function and the ``Engine(spec_ngram=...)`` held against the
JAX package on the CPU.

``plookup_propose`` is integer work and must be bit-exact.  The engines
run ``_llama_cfg()`` quantized all-MXFP4 by the JAX package (see
tests/test_torch_speculative.py for why), the JAX runner pointed at its
TPU branches (the flash and paged prefill kernels in interpret mode);
greedy outputs and the ``spec_*`` counters must be equal.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from __graft_entry__ import _llama_cfg
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve import speculative as jspec
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import speculative as tspec

PS, MP = 16, 8


@pytest.fixture
def jax_tpu_runner(monkeypatch):
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jrunner, "jax", proxy)
    monkeypatch.setattr(jrunner, "_can_pair", lambda *a: False)


@pytest.fixture(scope="module")
def model():
    jcfg = _llama_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, seed=1), host=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_plookup_propose_matches_jax():
    """The cases of tests/test_plookup.py (a match, none, a continuation cut
    by the valid length, a history shorter than ngram + 1, several matches
    of which the latest wins) with their expected proposals; then 96
    random histories over a 5-token vocabulary (many matches, lengths 0
    to the buffer's width) at three (gamma, ngram) pairs, bit-exact."""
    t = 12
    rows = np.zeros((5, t), np.int32)
    lens = np.array([6, 6, 5, 2, 9], np.int32)
    rows[0, :6] = [5, 6, 7, 8, 5, 6]
    rows[1, :6] = [1, 2, 3, 4, 5, 6]
    rows[2, :5] = [5, 1, 2, 1, 2]
    rows[3, :2] = [7, 7]
    rows[4, :9] = [5, 6, 1, 1, 5, 6, 2, 5, 6]
    got = tspec.plookup_propose(torch.from_numpy(rows), torch.from_numpy(lens),
                                gamma=3, ngram=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), [[7, 8, 5], [6, 6, 6], [1, 2, 2], [7, 7, 7], [2, 5, 6]])
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 5, (96, 40)).astype(np.int32)
    lens = rng.integers(0, 41, 96).astype(np.int32)
    for gamma, ngram in ((3, 2), (4, 1), (2, 3)):
        ref = jax.jit(lambda a, b, g=gamma, n=ngram: jspec.plookup_propose(
            a, b, gamma=g, ngram=n))(jnp.asarray(toks), jnp.asarray(lens))
        got = tspec.plookup_propose(torch.from_numpy(toks),
                                    torch.from_numpy(lens), gamma=gamma,
                                    ngram=ngram)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plookup_engine_matches_jax(model, jax_tpu_runner, monkeypatch):
    """ngram 2, gamma 3, 2 rounds a call, two slots, prefill_chunk 16: one
    request decodes for three steps, then a 40-token prompt arrives and
    its chunks ride the lookup call (``plookup_prefill_decode``) under
    mixed load.  Outputs (24 and 10 tokens: the tiny model's greedy paths
    fall into cycles, which the lookup finds) and the ``spec_*`` counters
    equal JAX's, with some proposals accepted; the outputs also equal the
    port's plain engine."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (5, 40)]
    new = [24, 10]
    kw = dict(max_seqs=2, page_size=PS, max_pages_per_seq=MP,
              prefill_buckets=(16, 32), prefill_chunk=16, seed=0)
    look = dict(spec_ngram=2, spec_gamma=3, spec_rounds=2)

    def drive(eng, mod):
        reqs = [mod.Request(i, p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new))]
        eng.submit(reqs[0])
        for _ in range(3):
            eng.step()
        eng.submit(reqs[1])
        while eng.step():
            pass
        return [r.output for r in reqs]

    jeng = jengine.Engine(jparams, jcfg, pipeline=False, **kw, **look)
    jout = drive(jeng, jengine)
    assert jeng._spec_piggy_cache and jeng.dcaches is None
    rides = []
    fused = tengine.plookup_prefill_decode
    monkeypatch.setattr(tengine, "plookup_prefill_decode",
                        lambda *a, **k: rides.append(1) or fused(*a, **k))
    teng = tengine.Engine(tparams, tcfg, device="cpu", **kw, **look)
    tout = drive(teng, tengine)
    assert teng.dcaches is None and rides
    assert [len(o) for o in tout] == new
    assert tout == jout
    assert teng.spec_proposed == jeng.spec_proposed > 0
    assert teng.spec_accepted == jeng.spec_accepted > 0
    plain = tengine.Engine(tparams, tcfg, device="cpu", **kw)
    assert [r.output for r in plain.run(
        [tengine.Request(i, p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, new))])] == jout


def test_spec_ngram_with_a_draft_is_refused_by_both(model):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(max_seqs=1, page_size=PS, max_pages_per_seq=4,
              prefill_buckets=(16,), spec_ngram=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jengine.Engine(jparams, jcfg, draft_params=jparams, draft_cfg=jcfg,
                       **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tengine.Engine(tparams, tcfg, draft_params=tparams, draft_cfg=tcfg,
                       device="cpu", **kw)
