"""Port parity: the request surface (logit controls, stop ids, logprobs,
the ``on_token`` stream, ``cancel``) of the sampler, ``decode_multi`` and
the ``Engine`` against the JAX package.

The model is a 2-layer Llama (hidden 128, vocab 512, GQA 4/2, seed 1),
quantized by the JAX package with every site all-MXFP4 and converted:
its GEMMs then sum grid values whose partial sums are exact in f32, so
both packages give the same K/V codes and near-equal logits, and greedy
paths do not part on near ties (a dense model's linears round one bf16
step apart in another sum order, which the int4 KV cache turns into
logits 0.016 apart).  The JAX prefill attention is pointed at its flash
kernel, as the port's prefill runs Kernel E's plain version.

Tolerances:
  * bit-exact: ``minp_shifts``, ``unpack_presence``, ``ban_mask`` and
    ``apply_logit_controls`` (against the jitted JAX functions);
  * greedy tokens equal (sampled rows draw from another generator);
  * logprobs: 1e-5 absolute (measured up to 9.6e-7): log_softmax of the
    raw f32 logits, whose attention and head sums run in another order
    and whose log_softmax sums do too.  The port's logprobs are held
    exactly against log_softmax of its own raw logits.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve import sampling as jsampling
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve import runner as trunner
from micromix_tpu_torch.serve import sampling as tsampling

CFG = dict(arch="llama", vocab_size=512, hidden_size=128,
           intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=32, rope_theta=10000.0, rms_eps=1e-6)
PS, MP = 16, 4
LP_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jcommon.ModelConfig(**CFG)
    tcfg = ModelConfig(**CFG)
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, seed=1), host=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture
def jax_flash_prefill(monkeypatch):
    monkeypatch.setattr(
        jrunner, "attention",
        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _controls(rng, b, v):
    """Presence, penalties 1.3 / 1 / 0.7 / 2, ban lists of 0-3 ids."""
    presence = rng.random((b, v)) < 0.2
    pen = np.array([1.3, 1.0, 0.7, 2.0][:b], np.float32)
    ban = np.array([[5, 7, -1], [-1, -1, -1], [3, -1, -1], [1, 2, v - 1]][:b],
                   np.int32)
    return presence, pen, ban


def test_controls_stage_bit_exact():
    rng = np.random.default_rng(0)
    b, v = 4, 1000
    logits = rng.normal(0, 3, (b, v)).astype(np.float32)
    logits[1, :10] = 0.0
    presence, pen, ban = _controls(rng, b, v)
    sp = [(0.8, 0.1), (0.0, 0.05), (1.0, 0.0), (1.3, 1.0)]
    jparams = [jsampling.SamplingParams(temperature=t, min_p=m) for t, m in sp]
    tparams = [tsampling.SamplingParams(temperature=t, min_p=m) for t, m in sp]
    mps = tsampling.minp_shifts(tparams + [None])
    np.testing.assert_array_equal(_bits(mps),
                                  _bits(jsampling.minp_shifts(jparams + [None])))
    assert mps[1] == 0.0 and np.isneginf(mps[2]) and mps[3] == 0.0
    mps = mps[:b]
    packed = np.packbits(presence, axis=1, bitorder="little")
    unpacked = tsampling.unpack_presence(torch.from_numpy(packed), v)
    np.testing.assert_array_equal(
        unpacked.numpy(),
        np.asarray(jax.jit(lambda p: jsampling.unpack_presence(p, v))(packed)))
    np.testing.assert_array_equal(unpacked.numpy(), presence)
    banned = tsampling.ban_mask(torch.from_numpy(ban), v)
    np.testing.assert_array_equal(
        banned.numpy(),
        np.asarray(jax.jit(lambda x: jsampling.ban_mask(x, v))(ban)))
    suppress = banned.numpy() & (np.arange(b) != 1)[:, None]
    for shift in (None, mps):
        ref = jax.jit(lambda lg, pr, pe, su, m: jsampling.apply_logit_controls(
            lg, pr, pe, su, minp_shift=m))(logits, presence, pen, suppress, shift)
        got = tsampling.apply_logit_controls(
            torch.from_numpy(logits), torch.from_numpy(presence),
            torch.from_numpy(pen), torch.from_numpy(suppress),
            None if shift is None else torch.from_numpy(shift))
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    # min-p at T = 0 keeps the argmax alone; a min_p of 1 keeps the max
    assert np.isfinite(got.numpy()[1]).sum() == 1
    assert np.isfinite(got.numpy()[3]).sum() == 1


@pytest.mark.parametrize("mode", tsampling.SAMPLE_MODES)
def test_sample_batch_under_controls_greedy_rows(mode):
    rng = np.random.default_rng(1)
    b, v = 4, 300
    logits = rng.normal(0, 3, (b, v)).astype(np.float32)
    presence, pen, ban = _controls(rng, b, v)
    # every row's own argmax is banned or penalized
    top = logits.argmax(-1)
    ban[:, 0] = top
    presence[np.arange(b), top] = True
    temps = np.array([0.0, 0.7, 0.0, 1.2], np.float32)
    if mode == "greedy":
        temps[:] = 0.0
    top_k = np.array([0, 5, 3, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5], np.float32)
    mps = tsampling.minp_shifts([tsampling.SamplingParams(temperature=float(t),
                                                          min_p=0.1)
                                 for t in temps])
    suppress = tsampling.ban_mask(torch.from_numpy(ban), v).numpy()
    x = tsampling.apply_logit_controls(
        torch.from_numpy(logits), torch.from_numpy(presence),
        torch.from_numpy(pen), torch.from_numpy(suppress),
        torch.from_numpy(mps))
    got = tsampling.sample_batch(
        x, torch.Generator().manual_seed(0), torch.from_numpy(temps),
        torch.from_numpy(top_k), torch.from_numpy(top_p), mode=mode).numpy()
    jx = jsampling.apply_logit_controls(
        jnp.asarray(logits), jnp.asarray(presence), jnp.asarray(pen),
        jnp.asarray(suppress), minp_shift=jnp.asarray(mps))
    ref = np.asarray(jsampling.sample_batch(
        jx, jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p), mode=mode))
    greedy = temps <= 0
    np.testing.assert_array_equal(got[greedy], ref[greedy])
    assert not np.any(got == top)            # no row took its banned argmax
    assert np.all(np.isfinite(x.numpy()[np.arange(b), got]))


def _caches(pkg, nseq, n_layers, nkv, hd):
    row = np.arange(1, MP + 1, dtype=np.int32)
    if pkg == "jax":
        pt = np.zeros((nseq + 1, MP), np.int32)
        for s in range(nseq):
            pt[s] = row + s * MP
        return [dataclasses.replace(
            jkv.make_cache(nseq * MP + 1, PS, nkv, hd, nseq + 1, MP),
            page_table=jnp.asarray(pt)) for _ in range(n_layers)]
    out = []
    for _ in range(n_layers):
        c = tkv.make_cache(nseq * MP + 1, PS, nkv, hd, nseq + 1, MP,
                           device="cpu")
        for s in range(nseq):
            c.page_table[s] = torch.from_numpy(row + s * MP)
        out.append(c)
    return out


def test_decode_multi_controls_and_logprobs(model):
    """Three greedy rows from empty caches, 6 steps: the first uncontrolled
    token of each row is banned for 3 steps (row 0) or penalized (rows 1,
    2), so the controlled tokens differ from the plain ones."""
    jcfg, tcfg, jparams, tparams = model
    b, v, n = 3, tcfg.vocab_size, 6
    toks = np.array([11, 200, 37], np.int32)
    seq = np.arange(b, dtype=np.int32)
    zero = np.zeros(b, np.int32)
    temps = np.zeros(b, np.float32)
    top_p = np.ones(b, np.float32)
    targs = [torch.from_numpy(a) for a in (toks, seq, zero)]
    tsamp = [torch.from_numpy(a) for a in (temps, zero, top_p)]
    shape = (b, tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim)
    plain, plps, _ = trunner.decode_multi(
        tparams, tcfg, _caches("torch", *shape), *targs, None, *tsamp,
        n_steps=n, sample_mode="greedy", with_logprobs=True)
    first = plain.numpy()[0]
    presence = np.zeros((b, v), bool)
    presence[np.arange(b), first] = True
    pen = np.array([1.0, 1.5, 0.5], np.float32)
    ban = np.full((b, 2), -1, np.int32)
    ban[0, 0] = first[0]
    mrem = np.array([3, 0, 0], np.int32)
    mps = tsampling.minp_shifts([tsampling.SamplingParams(min_p=0.1), None,
                                 tsampling.SamplingParams(min_p=0.2)])
    ctl = (np.packbits(presence, axis=1, bitorder="little"), pen, ban, mrem, mps)

    got, lps, _ = trunner.decode_multi(
        tparams, tcfg, _caches("torch", *shape), *targs, None, *tsamp,
        tuple(torch.from_numpy(a) for a in ctl), n_steps=n,
        sample_mode="greedy", with_logprobs=True)
    jtoks, jlps, _ = jax.jit(lambda p, c, ctl: jrunner.decode_multi(
        p, jcfg, c, jnp.asarray(toks), jnp.asarray(seq), jnp.asarray(zero),
        jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(zero),
        jnp.asarray(top_p), ctl, n_steps=n, sample_mode="greedy",
        with_logprobs=True))(jparams, _caches("jax", *shape),
                             tuple(jnp.asarray(a) for a in ctl))
    assert got.shape == (n, b) and lps.shape == (n, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=LP_ATOL)
    assert not np.array_equal(got.numpy(), plain.numpy())
    assert first[0] not in got.numpy()[:3, 0]
    # the logprobs are of the RAW logits: at step 0 (same cache state and
    # inputs as a plain step) log_softmax of the unpenalized logits
    logits0, _ = trunner.decode_step(tparams, tcfg, _caches("torch", *shape),
                                     *targs)
    raw = torch.log_softmax(logits0, dim=-1)[torch.arange(b), got[0].long()]
    assert torch.equal(lps[0], raw)
    assert not torch.equal(lps[0], plps[0])


def _requests(pkg, prompts, stop, eos, streams, cancel_at, engine_ref):
    mod = jengine if pkg == "jax" else tengine
    sp = jsampling.SamplingParams if pkg == "jax" else tsampling.SamplingParams

    def stream(i):
        def on_token(t):
            streams[i].append(t)
            if i == 2 and len(streams[i]) == cancel_at:
                assert engine_ref[0].cancel(2)
        return on_token

    return [
        mod.Request(0, prompts[0], max_new_tokens=9,
                    sampling=sp(repetition_penalty=1.3), stop_ids=stop,
                    logprobs=True, on_token=stream(0)),
        mod.Request(1, prompts[1], max_new_tokens=9,
                    sampling=sp(min_new_tokens=6), eos_id=eos[0],
                    stop_ids=eos[1:], logprobs=True, on_token=stream(1)),
        mod.Request(2, prompts[2], max_new_tokens=9,
                    sampling=sp(min_p=0.1, repetition_penalty=0.8),
                    on_token=stream(2)),
        mod.Request(3, prompts[3], max_new_tokens=5, logprobs=True,
                    on_token=stream(3)),
    ]


def test_engine_request_surface_matches_jax(model, jax_flash_prefill):
    """4 greedy requests on 4 slots, chunks of 4: a repetition penalty
    with a stop id, min_new_tokens against eos and a stop id, min-p with
    a penalty < 1 cancelled from its own on_token after 3 tokens, and a
    plain request with logprobs.  Stop ids and eos are taken from a probe
    run without them, where they fall early."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (9, 14, 12, 6)]
    kw = dict(max_seqs=4, page_size=PS, max_pages_per_seq=MP,
              prefill_buckets=(16,), decode_chunk=4, seed=0)
    probe_eng = [None]
    probe = tengine.Engine(tparams, tcfg, device="cpu", **kw)
    probe_eng[0] = probe
    streams = [[] for _ in range(4)]
    preqs = probe.run(_requests("torch", prompts, None, [None], streams, 99,
                                probe_eng))
    stop = [preqs[0].output[4]]
    eos = [preqs[1].output[1], preqs[1].output[3]]
    outs = {}
    for pkg in ("jax", "torch"):
        streams = [[] for _ in range(4)]
        ref = [None]
        if pkg == "jax":
            eng = jengine.Engine(jparams, jcfg, pipeline=False, **kw)
        else:
            eng = tengine.Engine(tparams, tcfg, device="cpu", **kw)
        ref[0] = eng
        reqs = eng.run(_requests(pkg, prompts, stop, eos, streams, 3, ref))
        outs[pkg] = (reqs, streams, eng)
    (jreqs, _, _), (treqs, tstreams, teng) = outs["jax"], outs["torch"]
    for jr, tr, s in zip(jreqs, treqs, tstreams):
        assert tr.done and jr.done
        assert tr.output == jr.output, tr.req_id
        assert s == tr.output
        assert len(tr.token_logprobs) == (len(tr.output) if tr.logprobs else 0)
        np.testing.assert_allclose(tr.token_logprobs, jr.token_logprobs,
                                   atol=LP_ATOL)
    r0, r1, r2, r3 = treqs
    assert r0.output[-1] == stop[0] and stop[0] not in r0.output[:-1]
    assert len(r0.output) <= 5
    assert not set(eos) & set(r1.output[:6])
    assert r1.output != preqs[1].output[:len(r1.output)]
    assert len(r2.output) == 3
    assert len(r3.output) == 5
    assert teng.block_manager.num_free == teng.block_manager.n_pages - 1
    assert all(s.req is None for s in teng.slots)
    assert teng.phase_steps["mixed"] == 0     # controls turn piggyback off


def test_cancel_queued_and_unknown(model):
    _, tcfg, _, tparams = model
    eng = tengine.Engine(tparams, tcfg, device="cpu", max_seqs=1,
                         page_size=PS, max_pages_per_seq=MP,
                         prefill_buckets=(16,), decode_chunk=2)
    a = tengine.Request(0, [1, 2, 3], max_new_tokens=4)
    b = tengine.Request(1, [4, 5, 6], max_new_tokens=4)
    eng.submit(a)
    eng.submit(b)
    assert eng.step()
    assert eng.cancel(1) and b.done and b.output == []
    assert not eng.cancel(1) and not eng.cancel(7)
    assert eng.cancel(0) and a.done and eng.slots[0].req is None
    assert not eng.step()
