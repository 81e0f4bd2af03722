"""Port parity for the prefix cache: ``PrefixBlockManager`` and the
``Engine(prefix_cache=True)``, alone and with a draft model, held against
the JAX package on the CPU.

The block manager is host code over numpy: its pages, hits, free counts
and evictions must be identical.  The engines run ``_llama_cfg()``
quantized all-MXFP4 by the JAX package (see tests/test_torch_speculative.py
for why), the JAX runner pointed at its TPU branches (a hit prefills over
the quantized history through the paged prefill kernel, in interpret
mode); greedy outputs and ``prefix_hit_tokens`` must be equal.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from __graft_entry__ import _llama_cfg
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve.prefix_cache import PrefixBlockManager as JPrefix
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve.prefix_cache import PrefixBlockManager as TPrefix

PS = 16


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


def _state(bm):
    return (bm.num_free, [bm.table_row(s).tolist() for s in range(bm.max_seqs)],
            list(bm._evictable), dict(bm._map), dict(bm._ref))


def test_prefix_block_manager_matches_jax():
    """600 seeded operations on both managers (12 pages of 4 tokens, 3
    slots of at most 5 pages): admit a context (match, then ensure its
    length), grow a slot, register its prefix, release it.  Contexts are
    three base prompts with random cuts and tails, so chains share,
    diverge and are evicted under pool pressure.  Every return value,
    refusal, page table, free count, eviction order and map entry is
    equal after every operation."""
    rng = np.random.default_rng(21)
    j, t = JPrefix(12, 4, 3, 5), TPrefix(12, 4, 3, 5)
    bases = [rng.integers(0, 3, 20).tolist() for _ in range(3)]
    ctx = [None] * 3
    hits = refusals = evictions = 0
    for _ in range(600):
        slot = int(rng.integers(3))
        op = rng.choice(["admit", "grow", "register", "release"])
        if op == "admit" and ctx[slot] is None:
            base = bases[int(rng.integers(3))]
            c = base[:int(rng.integers(1, 21))] + rng.integers(
                0, 3, int(rng.integers(0, 6))).tolist()
            got = t.match_and_attach(slot, c)
            assert got == j.match_and_attach(slot, c)
            hits += got > 0
            ctx[slot] = c
            op, n = "ensure", len(c)
        elif op == "grow" and ctx[slot] is not None:
            ctx[slot] = ctx[slot] + rng.integers(0, 3, 3).tolist()
            op, n = "ensure", len(ctx[slot])
        if op == "ensure":
            cached = len(t._map)
            try:
                row = t.ensure(slot, n)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    j.ensure(slot, n)
                refusals += 1
            else:
                np.testing.assert_array_equal(row, j.ensure(slot, n))
            evictions += len(t._map) < cached
        elif op == "register" and ctx[slot] is not None:
            covered = int(rng.integers(0, len(ctx[slot]) + 1))
            t.register_prefix(slot, ctx[slot], covered)
            j.register_prefix(slot, ctx[slot], covered)
        elif op == "release":
            t.release(slot)
            j.release(slot)
            ctx[slot] = None
        assert _state(t) == _state(j)
    assert hits > 20 and refusals > 5 and evictions > 5


def _sequence(eng, mod, prompts_rng):
    """The cases of tests/test_prefix_cache.py on one engine, one after
    another -> per case (outputs, hit tokens added, preemptions added)."""
    v = 512
    out = []

    def run(reqs):
        h0, p0 = eng.prefix_hit_tokens, eng.preemptions
        eng.run(reqs)
        assert all(r.done for r in reqs)
        out.append(([r.output for r in reqs], eng.prefix_hit_tokens - h0,
                    eng.preemptions - p0))

    rng = np.random.default_rng(prompts_rng)
    replay = rng.integers(0, v, 33).tolist()
    run([mod.Request(0, list(replay), max_new_tokens=6)])
    run([mod.Request(1, list(replay), max_new_tokens=6)])
    shared = rng.integers(0, v, 32).tolist()
    run([mod.Request(2, shared + [1, 2, 3], max_new_tokens=4)])
    run([mod.Request(3, shared + [9, 8, 7, 6], max_new_tokens=4),
         mod.Request(4, rng.integers(0, v, 20).tolist(), max_new_tokens=4)])
    turn1 = rng.integers(0, v, 30).tolist()
    first = mod.Request(5, list(turn1), max_new_tokens=6)
    run([first])
    run([mod.Request(6, turn1 + first.output + [5, 7], max_new_tokens=4)])
    run([mod.Request(7 + i, rng.integers(0, v, 17).tolist(), max_new_tokens=16)
         for i in range(3)])
    return out


def test_prefix_cache_engine_matches_jax(model, jax_tpu_runner):
    """One engine of each package (three slots, a pool of 7 usable pages
    of 16 tokens, at most 4 a sequence, prefill_chunk 32) serves, in turn:
    a 33-token prompt twice (the second hits its 32 cached tokens and
    replays the first's output exactly: the match point is the first's
    chunk boundary), a shared 32-token prefix with two tails and an
    unrelated prompt beside the second, a finished turn and a follow-up
    whose prompt extends it (its generated tokens' page hits), and three
    17-token prompts whose decode outgrows the pool (cached pages are
    evicted, then a request is preempted and recovers its prefix from the
    cache).  Per case the outputs, hit tokens and preemptions equal
    JAX's."""
    jcfg, tcfg, jparams, tparams = model
    kw = dict(max_seqs=3, page_size=PS, max_pages_per_seq=4, n_pages=8,
              prefill_buckets=(16, 32, 64), prefill_chunk=32, decode_chunk=2,
              prefix_cache=True, seed=0)
    jeng = jengine.Engine(jparams, jcfg, pipeline=False, **kw)
    ref = _sequence(jeng, jengine, 31)
    teng = tengine.Engine(tparams, tcfg, device="cpu", **kw)
    got = _sequence(teng, tengine, 31)
    assert got == ref
    assert [h for _, h, _ in got[:6]] == [0, 32, 0, 32, 0, 32]
    assert got[1][0] == got[0][0]
    assert got[6][2] > 0 and got[6][1] > 0
    assert teng.block_manager.num_free == teng.block_manager.n_pages - 1


def test_prefix_cache_with_a_draft_matches_jax(model, jax_tpu_runner):
    """Prefix caching with speculation (the truncated-alias draft, gamma 2,
    one round a call): the draft's caches hold its own K/V on the shared
    pages at the same physical ids, so a second run of a 33-token prompt
    hits 32 tokens and replays the first's output; outputs, hits and
    ``spec_*`` counters equal JAX's."""
    jcfg, tcfg, jparams, tparams = model
    prompt = np.random.default_rng(32).integers(0, 512, 33).tolist()
    kw = dict(max_seqs=1, page_size=PS, max_pages_per_seq=8,
              prefill_buckets=(16, 32), decode_chunk=2, prefix_cache=True,
              spec_gamma=2, spec_rounds=1, seed=0)

    def run(eng, mod):
        outs = [eng.run([mod.Request(i, list(prompt), max_new_tokens=6)])[0]
                .output for i in range(2)]
        return outs, eng.prefix_hit_tokens, eng.spec_proposed, eng.spec_accepted

    jeng = jengine.Engine(jparams, jcfg, pipeline=False, **kw,
                          draft_params={**jparams, "layers": jparams["layers"][:1]},
                          draft_cfg=dataclasses.replace(jcfg, num_layers=1))
    ref = run(jeng, jengine)
    teng = tengine.Engine(tparams, tcfg, device="cpu", **kw,
                          draft_params={**tparams, "layers": tparams["layers"][:1]},
                          draft_cfg=dataclasses.replace(tcfg, num_layers=1))
    got = run(teng, tengine)
    assert got == ref
    outs, hits, proposed, _ = got
    assert hits == 32 and proposed > 0 and outs[1] == outs[0]
