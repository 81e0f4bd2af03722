"""Pipelined decode (the engine's default, ``pipeline=True``): the port's
counterparts of tests/test_engine.py's pipelining tests, on the CPU.

A pipelined chunk is dispatched from the in-flight chunk's device-side
last tokens before that chunk's tokens are emitted, so the check is
equality: the same token streams as the unpipelined engine (greedy and
sampled: the generator draws the same (B, V) arrays in the same order),
and the JAX engine's greedy tokens with its own pipelining on.  Each
test also counts the pipelined dispatches, so that none passes with the
pipeline idle.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from __graft_entry__ import _llama_cfg
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve.sampling import SamplingParams

KW = dict(max_seqs=4, page_size=16, max_pages_per_seq=8,
          prefill_buckets=(16, 32), decode_chunk=4, seed=3, device="cpu")


@pytest.fixture(scope="module")
def port_model():
    cfg = ModelConfig(**dataclasses.asdict(_llama_cfg(vocab_size=128)))
    params = tsurg.random_quantized_model(
        cfg, tsurg.default_calibration(cfg, p6=128, p8=128, seed=0), seed=70,
        device="cpu")
    return cfg, params


def _run(params, cfg, reqs, pipeline, **kw):
    """One engine run -> (engine, pipelined dispatches)."""
    eng = tengine.Engine(params, cfg, pipeline=pipeline, **dict(KW, **kw))
    count = [0]
    dispatch = eng._dispatch

    def counted(*args):
        count[0] += 1
        return dispatch(*args)

    eng._dispatch = counted
    eng.run(reqs)
    assert eng._inflight is None
    return eng, count[0]


@pytest.mark.parametrize("traffic", ["streams", "churn"])
def test_pipelined_streams_equal_unpipelined(port_model, traffic):
    """streams: four slots, greedy and sampled (T = 0.8, 1.2) requests with
    staggered ``max_new_tokens`` and one that ends at an eos mid-stream
    (its eos is its own 6th token of a probe run, so the pipelined engine
    decodes one dropped chunk after it); churn: ten greedy requests over
    four slots, finishes draining the pipeline and admissions restarting
    it.  The token streams equal the unpipelined engine's."""
    cfg, params = port_model
    rng = np.random.default_rng(7)
    if traffic == "streams":
        prompts = [rng.integers(0, cfg.vocab_size, 5 + i).tolist() for i in range(4)]
        sampling = [SamplingParams(), SamplingParams(temperature=0.8),
                    SamplingParams(), SamplingParams(temperature=1.2)]
        new = [13, 7, 17, 9]
        probe = [tengine.Request(2, list(prompts[2]), max_new_tokens=17)]
        _run(params, cfg, probe, pipeline=False)
        out = probe[0].output
        eos = next(t for j, t in enumerate(out) if j >= 5 and t not in out[:j])

        def mk():
            return [tengine.Request(i, list(p), max_new_tokens=n, sampling=sp,
                                    eos_id=eos if i == 2 else None)
                    for i, (p, n, sp) in enumerate(zip(prompts, new, sampling))]
    else:
        prompts = [rng.integers(0, cfg.vocab_size, 4 + i % 5).tolist()
                   for i in range(10)]

        def mk():
            return [tengine.Request(i, list(p), max_new_tokens=5 + (i % 3) * 4)
                    for i, p in enumerate(prompts)]

    a, b = mk(), mk()
    _, dispatched = _run(params, cfg, a, pipeline=True)
    _, none = _run(params, cfg, b, pipeline=False)
    assert dispatched > 0 and none == 0
    for ra, rb in zip(a, b):
        assert ra.done and ra.output == rb.output, (ra.req_id, ra.output, rb.output)
    if traffic == "streams":
        assert a[2].output[-1] == eos and len(a[2].output) < 17


def test_pipelined_cancel_midflight(port_model):
    """A cancel while a chunk is in flight drops that request's pending
    rows: it stops early, with no token of another request, and the other
    request's stream is the unpipelined engine's."""
    cfg, params = port_model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, 6).tolist() for _ in range(2)]

    def mk():
        return [tengine.Request(i, list(p), max_new_tokens=20)
                for i, p in enumerate(prompts)]

    reqs = mk()
    eng = tengine.Engine(params, cfg, pipeline=True, **dict(KW, max_seqs=2))
    for r in reqs:
        eng.submit(r)
    steps = cancelled_in_flight = 0
    while eng.step():
        steps += 1
        if eng._inflight is not None and not reqs[0].done:
            assert eng.cancel(0)
            cancelled_in_flight += 1
        assert steps < 100
    assert cancelled_in_flight == 1 and eng._inflight is None
    assert reqs[0].done and reqs[1].done
    assert len(reqs[0].output) < 20 and len(reqs[1].output) == 20
    ref = mk()
    _run(params, cfg, ref, pipeline=False, max_seqs=2)
    assert reqs[1].output == ref[1].output
    assert reqs[0].output == ref[0].output[:len(reqs[0].output)]


def test_pipelined_greedy_matches_jax_engine(monkeypatch):
    """Both engines with pipelining on (their default), per-consumer
    params (``MICROMIX_NO_STACK``, so both decode per site), the JAX
    prefill on its flash kernel: five requests over two slots, decode
    chunks of 4, finishes at ``max_new_tokens`` inside an in-flight chunk
    and admissions between.  Greedy tokens equal."""
    jcfg = _llama_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, p6=128, p8=128, seed=1), host=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    monkeypatch.setattr(jrunner, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    monkeypatch.setenv("MICROMIX_NO_STACK", "1")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (9, 14, 20, 6, 11)]
    new = [6, 11, 5, 9, 7]
    kw = dict(max_seqs=2, page_size=16, max_pages_per_seq=8,
              prefill_buckets=(16, 32), decode_chunk=4, seed=0)
    jeng = jengine.Engine(jparams, jcfg, piggyback=False, pipeline=True, **kw)
    jreqs = jeng.run([jengine.Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, new))])
    treqs = [tengine.Request(i, p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new))]
    teng, dispatched = _run(tparams, tcfg, treqs, pipeline=True, **kw,
                            device="cpu")
    assert dispatched > 0
    for jr, tr, n in zip(jreqs, treqs, new):
        assert tr.done and len(tr.output) == n
        assert tr.output == jr.output
