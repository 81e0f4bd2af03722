"""Port parity for speculative decoding with a draft model: the runner's
``verify_block``, ``accept_tokens`` and the spec ``Engine``, held against
the JAX package on the CPU.

The JAX runner is pointed at its TPU branches (``jax_tpu_runner``, as in
tests/test_torch_prefill.py): its prefill runs the flash and paged
prefill kernels in interpret mode, which the port's prefill mirrors, and
its decode stays unpaired, as its verify is.

The model is ``_llama_cfg()`` (2 layers, hidden 512, vocab 512, GQA 8/4),
quantized by the JAX package with every site all-MXFP4, as in
tests/test_torch_controls.py: its GEMMs sum grid values whose partial
sums are exact in f32, so greedy paths do not part on near ties (with
int6 / int8 segments, a chunk over history already differs between the
packages by 0.19 in the logits, whose top two lie 0.014 apart).

Tolerances:
  * ``verify_block`` logits, from one cache state: |diff| <= VERIFY_ATOL.
    The two sides differ by f32 sums in another order and by K's RoPE:
    the JAX CPU program contracts it into an FMA, the port rounds each
    product (ROADMAP 3.2), so a rare K element is one bf16 step off and
    can move its row's int4 grid.  The logits of this model span about 3;
    the largest difference measured is 5.8e-3;
  * ``accept_tokens``: greedy rows bit-exact; sampled rows, given JAX's
    uniforms and Gumbel noise, the same accept counts and tokens, and a
    residual within 1e-6 of its float64 formula;
  * engines: equal greedy tokens and equal ``spec_proposed`` /
    ``spec_accepted``.
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
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve import speculative as jspec
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve import runner as trunner
from micromix_tpu_torch.serve import speculative as tspec

PS, MP = 16, 8
VERIFY_ATOL = 0.05


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


def _bf16_to_jax(t: torch.Tensor):
    return jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)


def _to_jax(caches):
    return [jkv.PagedKVCache(
        k_codes=jnp.asarray(c.k_codes.numpy()),
        v_codes=jnp.asarray(c.v_codes.numpy()), k_sz=_bf16_to_jax(c.k_sz),
        v_sz=_bf16_to_jax(c.v_sz), page_table=jnp.asarray(c.page_table.numpy()),
        lengths=jnp.asarray(c.lengths.numpy()), bits=c.bits) for c in caches]


def test_verify_block_matches_jax(model):
    """Two slots and the scratch row, gamma + 1 = 4 positions each: the
    caches are prefilled by the port, copied to JAX, and both sides'
    ``verify_block`` score the same block from that state; then both roll
    back to keep 2 of the 4 positions and score the next block."""
    jcfg, tcfg, jparams, tparams = model
    jst = jsurg.stack_layer_projections(jparams)
    tst = tsurg.stack_layer_projections(tparams)
    rng = np.random.default_rng(11)
    b, scratch = 3, 2
    table = np.zeros((b, MP), np.int32)
    table[0], table[1] = np.arange(1, MP + 1), np.arange(MP + 1, 2 * MP + 1)
    caches = [tkv.make_cache(2 * MP + 1, PS, tcfg.num_kv_heads, tcfg.head_dim,
                             b, MP, device="cpu") for _ in range(tcfg.num_layers)]
    for c in caches:
        c.page_table.copy_(torch.from_numpy(table))
    starts = [19, 33]
    for i, n in enumerate(starts):
        toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (1, n)))
        trunner.prefill(tst, tcfg, caches, toks.to(torch.int32), i)
    seq = np.array([0, 1, scratch], np.int32)
    pos = np.array(starts + [1], np.int32)
    jverify = jax.jit(lambda p, c, t, s, q: jrunner.verify_block(
        p, jcfg, c, t, s, q))
    for keep in (None, 2):
        if keep is not None:        # roll both sides back to pos + keep
            pos = pos + keep
            tspec._set_lengths(caches, torch.from_numpy(seq),
                               torch.from_numpy(pos))
        block = rng.integers(0, tcfg.vocab_size, (b, 4)).astype(np.int32)
        jc = _to_jax(caches)
        jlog, _ = jverify(jst, jc, jnp.asarray(block), jnp.asarray(seq),
                          jnp.asarray(pos))
        tlog, caches = trunner.verify_block(
            tst, tcfg, caches, torch.from_numpy(block), torch.from_numpy(seq),
            torch.from_numpy(pos))
        ref = np.asarray(jlog)[:2]
        got = tlog.numpy()[:2]
        assert tlog.dtype == torch.float32 and tlog.shape == (b, 4, 512)
        err = np.abs(got - ref).max()
        assert err <= VERIFY_ATOL, err
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        np.testing.assert_array_equal(caches[0].lengths.numpy()[:2],
                                      pos[:2] + 4)


_J_ACCEPT = jax.jit(jspec.accept_tokens)


def _accept(proposed, dprobs, tlogits, temps, key):
    """JAX's accept_tokens, and the port's given JAX's uniforms and noise."""
    b, gamma = proposed.shape
    je, jn, _ = _J_ACCEPT(jnp.asarray(proposed), jnp.asarray(dprobs),
                          jnp.asarray(tlogits), key, jnp.asarray(temps))
    u = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (b, gamma)))
    g = np.asarray(jax.random.gumbel(jax.random.fold_in(key, 2),
                                     (b, tlogits.shape[-1])))
    te, tn, mask = tspec.accept_tokens(
        torch.from_numpy(proposed), torch.from_numpy(dprobs),
        torch.from_numpy(tlogits), None, torch.from_numpy(temps),
        uniforms=torch.from_numpy(u), gumbel=torch.from_numpy(g))
    assert mask.numpy().sum(-1).tolist() == tn.numpy().tolist()
    return (np.asarray(je), np.asarray(jn)), (te.numpy(), tn.numpy())


def test_accept_tokens_matches_jax():
    """The constructed cases of tests/test_speculative.py and
    tests/test_plookup.py bit-exact (greedy rows also with ``greedy=True``,
    no draft distributions); then 64 sampled rows whose proposals follow
    the target's top tokens, given JAX's uniforms and Gumbel noise."""
    key = jax.random.PRNGKey(1)
    b, gamma, v = 2, 3, 8
    base = np.asarray(jax.nn.softmax(
        jnp.linspace(0.0, 1.0, v)[None, None, :] * jnp.ones((b, gamma + 1, 1)),
        axis=-1), np.float32)
    same = np.full((b, gamma), int(base[0, 0].argmax()), np.int32)
    zero_t = np.full((b, gamma + 1, v), -1e30, np.float32)
    zero_t[:, :, 3] = 0.0
    on5 = np.zeros((b, gamma, v), np.float32)
    on5[:, :, 5] = 1.0
    tl = np.random.default_rng(3).normal(0, 1, (b, gamma + 1, v)).astype(np.float32)
    tm = tl.argmax(-1)
    prop = np.stack([tm[:, 0], tm[:, 1], (tm[:, 2] + 1) % v], 1).astype(np.int32)
    plk = np.full((b, gamma + 1, 16), -10.0, np.float32)
    for j, (t0, t1) in enumerate(zip([4, 5, 9, 2], [7, 1, 1, 1])):
        plk[0, j, t0] = plk[1, j, t1] = 0.0
    plk_prop = np.array([[4, 5, 6], [4, 5, 6]], np.int32)
    ones, zeros = np.ones((b,), np.float32), np.zeros((b,), np.float32)
    cases = [  # (proposed, dprobs, tlogits, temps, n_emitted, emitted[:, 0])
        (same, base[:, :gamma], np.log(base), ones, [4, 4], None),
        (np.full((b, gamma), 5, np.int32), on5, zero_t, ones, [1, 1], [3, 3]),
        (prop, np.asarray(jax.nn.softmax(tl[:, :gamma], -1)), tl, zeros,
         [3, 3], tm[:, 0]),
        (plk_prop, np.eye(16, dtype=np.float32)[plk_prop], plk, zeros, [3, 1],
         [4, 7]),
    ]
    for proposed, dprobs, tlogits, temps, n_ref, first in cases:
        (je, jn), (te, tn) = _accept(proposed, dprobs, tlogits, temps, key)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tn, n_ref)
        np.testing.assert_array_equal(te, je)
        if first is not None:
            np.testing.assert_array_equal(te[:, 0], first)
        if not temps.any():
            ge, gn, _ = tspec.accept_tokens(
                torch.from_numpy(proposed), None, torch.from_numpy(tlogits),
                None, torch.from_numpy(temps), greedy=True)
            np.testing.assert_array_equal(ge.numpy(), je)
            np.testing.assert_array_equal(gn.numpy(), jn)

    # sampled rows: a draft near the target, proposals its top-2 tokens
    rng = np.random.default_rng(4)
    b, v = 64, 50
    tlogits = rng.normal(0, 2, (b, gamma + 1, v)).astype(np.float32)
    dlogits = tlogits[:, :gamma] + rng.normal(0, 0.7, (b, gamma, v)).astype(np.float32)
    temps = np.where(np.arange(b) % 8 == 0, 0.0,
                     rng.uniform(0.5, 1.5, b)).astype(np.float32)
    dprobs = np.asarray(jax.vmap(jspec._softmax_t, (1, None), 1)(
        jnp.asarray(dlogits), jnp.asarray(temps)))
    top2 = np.argsort(-dlogits, -1)[..., :2]
    proposed = np.where(rng.random((b, gamma)) < 0.7, top2[..., 0],
                        top2[..., 1]).astype(np.int32)
    for seed in range(3):
        (je, jn), (te, tn) = _accept(proposed, dprobs, tlogits, temps,
                                     jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(te, je)
        assert 0 < (tn == 1).sum() and (tn == gamma + 1).sum() > 0
    # the port's residual against its float64 formula, and every sampled
    # row's fixup token (after a rejection) inside its support
    a = tn - 1
    tp = tspec._softmax_t(torch.from_numpy(tlogits), torch.from_numpy(temps))
    got = tspec._residual(tp, torch.from_numpy(dprobs),
                          torch.from_numpy(a).long()).numpy()
    t = np.maximum(temps, 1e-6)[:, None, None].astype(np.float64)
    z = tlogits / t
    p64 = np.exp(z - z.max(-1, keepdims=True))
    p64 /= p64.sum(-1, keepdims=True)
    p64[temps <= 0] = np.eye(v)[tlogits[temps <= 0].argmax(-1)]
    rows, sel = np.arange(b), np.minimum(a, gamma)
    d_at = np.concatenate([dprobs, np.zeros((b, 1, v), np.float32)], 1)[rows, sel]
    ref = np.maximum(p64[rows, sel] - np.where((a < gamma)[:, None], d_at, 0.0),
                     0.0)
    noisy = temps > 0
    ref = ref[noisy] / ref[noisy].sum(-1, keepdims=True)
    assert np.abs(got[noisy] - ref).max() <= 1e-6
    rejected = (temps > 0) & (a < gamma)
    assert rejected.any()
    assert (got[rows, te[rows, a]][rejected] > 0).all()


def test_spec_engine_matches_jax(model, jax_tpu_runner, monkeypatch):
    """The spec engine of both packages (the truncated-alias draft: the
    target's first layer with its embed and head; gamma 3, 2 rounds a
    call, greedy), two slots, prefill_chunk 16: the first two prompts
    prefill batched (the draft mirrors the batch), the 40-token one in
    three chunks that ride the spec call (``spec_prefill_decode``, the
    draft mirroring each chunk), the last one alone.  Outputs and the
    ``spec_*`` counters equal JAX's; the outputs also equal the port's
    spec engine with piggyback off and the port's plain engine.  The
    draft holds no second copy of its layer."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (6, 9, 40, 11)]
    new = [7, 9, 8, 6]
    kw = dict(max_seqs=2, page_size=PS, max_pages_per_seq=MP,
              prefill_buckets=(16, 32), prefill_chunk=16, seed=0)
    spec = dict(spec_gamma=3, spec_rounds=2)

    def run(eng, mod):
        return [r.output for r in eng.run(
            [mod.Request(i, p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new))])]

    jeng = jengine.Engine(
        jparams, jcfg, pipeline=False, **kw, **spec,
        draft_params={**jparams, "layers": jparams["layers"][:1]},
        draft_cfg=dataclasses.replace(jcfg, num_layers=1))
    jout = run(jeng, jengine)
    assert jeng._spec_piggy_cache
    rides = []
    fused = tengine.spec_prefill_decode
    monkeypatch.setattr(tengine, "spec_prefill_decode",
                        lambda *a, **k: rides.append(1) or fused(*a, **k))
    draft = dict(draft_params={**tparams, "layers": tparams["layers"][:1]},
                 draft_cfg=dataclasses.replace(tcfg, num_layers=1))
    outs = {}
    for name, extra in (("spec", {}), ("no piggyback", dict(piggyback=False))):
        teng = tengine.Engine(tparams, tcfg, device="cpu", **kw, **spec,
                              **draft, **extra)
        outs[name] = run(teng, tengine)
        if not extra:
            assert rides, "no prefill chunk rode the spec call"
            assert teng.spec_proposed == jeng.spec_proposed > 0
            assert teng.spec_accepted == jeng.spec_accepted
            assert teng.phase_steps["spec"] > 0 and teng.phase_s["spec"] > 0
        assert teng.draft_params["layers"][0] is teng.params["layers"][0]
        assert "qkv_stack" in teng.draft_params["layers"][0]
        assert teng.block_manager.num_free == teng.block_manager.n_pages - 1
    plain = tengine.Engine(tparams, tcfg, device="cpu", **kw)
    outs["plain"] = run(plain, tengine)
    assert [len(o) for o in jout] == new
    for name, out in outs.items():
        assert out == jout, name
