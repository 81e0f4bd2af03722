"""Port parity for the whole slice: prefill + decode_multi greedy tokens,
the continuous-batching engine, sampling, the block manager, device
resolution and import isolation.

The JAX runner takes its XLA attention on the CPU for prefill; on the
TPU it runs its flash kernel.  The tests point it at that kernel (in
interpret mode), which the port's prefill mirrors, so both sides follow
the TPU path.  Greedy tokens must then be equal.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from __graft_entry__ import _llama_cfg
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import block_manager as jbm
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve import sampling as jsampling
from micromix_tpu_torch import resolve_device
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import block_manager as tbm
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve import runner as trunner
from micromix_tpu_torch.serve import sampling as tsampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS, MP = 16, 8


@pytest.fixture(scope="module")
def model():
    jcfg = _llama_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, p6=128, p8=128, seed=1), host=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture
def jax_flash_prefill(monkeypatch):
    """The JAX runner's prefill attention -> its TPU flash kernel."""
    monkeypatch.setattr(
        jrunner, "attention",
        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))


def _prompts(vocab, lengths, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def test_prefill_and_decode_multi_greedy_tokens_match_jax(model,
                                                          jax_flash_prefill):
    jcfg, tcfg, jparams, tparams = model
    (prompt,) = _prompts(jcfg.vocab_size, [13])
    row = np.array([3, 1, 4, 0, 0, 0, 0, 0], np.int32)
    n_layers, nkv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim

    jc = [dataclasses.replace(
        jkv.make_cache(6, PS, nkv, hd, 2, MP),
        page_table=jnp.zeros((2, MP), jnp.int32).at[0].set(row))
        for _ in range(n_layers)]
    tc = [tkv.make_cache(6, PS, nkv, hd, 2, MP, device="cpu") for _ in range(n_layers)]
    for c in tc:
        c.page_table[0] = torch.from_numpy(row)

    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompt
    jlog, jc = jax.jit(lambda p, c, t: jrunner.prefill(
        p, jcfg, c, t, jnp.int32(0), jnp.int32(0), jnp.int32(12)))(
            jparams, jc, jnp.asarray(toks))
    tlog, tc = trunner.prefill(tparams, tcfg, tc, torch.from_numpy(toks), 0,
                               last_idx=12)
    first = int(np.argmax(np.asarray(jlog)[0]))
    assert int(torch.argmax(tlog[0])) == first
    jc = [dataclasses.replace(c, lengths=c.lengths.at[0].set(13)) for c in jc]
    for c in tc:
        c.lengths[0] = 13

    z = np.zeros((1,), np.float32)
    jtoks, _ = jax.jit(lambda p, c: jrunner.decode_multi(
        p, jcfg, c, jnp.asarray([first], jnp.int32), jnp.asarray([0], jnp.int32),
        jnp.asarray([13], jnp.int32), jax.random.PRNGKey(0), jnp.asarray(z),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.float32), n_steps=8,
        sample_mode="greedy"))(jparams, jc)
    ttoks, _ = trunner.decode_multi(
        tparams, tcfg, tc, torch.tensor([first]), torch.tensor([0]),
        torch.tensor([13]), None, torch.from_numpy(z),
        torch.zeros(1, dtype=torch.int32), torch.ones(1), n_steps=8,
        sample_mode="greedy")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_engine_run_matches_jax_engine(model, jax_flash_prefill, monkeypatch):
    """3 requests, 2 slots: a batched prefill of two prompts, a later
    single-slot prefill after a retire, decode chunks of 4, eos-free
    retire at max_new_tokens.  Nothing chunks or preempts."""
    _engine_parity(model, monkeypatch, PS, MP)


def test_engine_run_matches_jax_engine_on_256_token_pages(
        model, jax_flash_prefill, monkeypatch):
    """The same run on pages of 256 tokens (the JAX package's page size on
    its chip is a multiple of 128; the card walks such a page in stages of
    128)."""
    _engine_parity(model, monkeypatch, 256, 1)


def _engine_parity(model, monkeypatch, page_size, max_pages):
    jcfg, tcfg, jparams, tparams = model
    monkeypatch.setenv("MICROMIX_NO_STACK", "1")
    prompts = _prompts(jcfg.vocab_size, [9, 14, 20])
    new = [6, 9, 5]
    kw = dict(max_seqs=2, page_size=page_size, max_pages_per_seq=max_pages,
              prefill_buckets=(16, 32), decode_chunk=4, seed=0)
    jeng = jengine.Engine(jparams, jcfg, piggyback=False, pipeline=False, **kw)
    jreqs = jeng.run([jengine.Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, new))])
    teng = tengine.Engine(tparams, tcfg, device="cpu", **kw)
    treqs = teng.run([tengine.Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, new))])
    for jr, tr, n in zip(jreqs, treqs, new):
        assert tr.done and len(tr.output) == n
        assert tr.output == jr.output
    assert teng.prefill_tokens == sum(len(p) for p in prompts)
    assert teng.block_manager.num_free == teng.block_manager.n_pages - 1


def test_engine_limits_raise(model):
    """With no other request to preempt, a prompt whose next chunk or a
    sequence whose next decode chunk outgrows its page cap raises.
    (Chunked prefill lifts the largest-bucket limit on prompts.)"""
    _, tcfg, _, tparams = model
    kw = dict(max_seqs=1, page_size=PS, max_pages_per_seq=1,
              prefill_buckets=(16,), decode_chunk=4, device="cpu")
    eng = tengine.Engine(tparams, tcfg, **kw)
    eng.submit(tengine.Request(0, list(range(17))))
    with pytest.raises(RuntimeError, match="too small for this prompt"):
        while eng.step():
            pass
    eng = tengine.Engine(tparams, tcfg, **kw)
    eng.submit(tengine.Request(1, list(range(10)), max_new_tokens=20))
    with pytest.raises(RuntimeError, match="too small for a single sequence"):
        while eng.step():
            pass


@pytest.mark.parametrize("mode", tsampling.SAMPLE_MODES)
def test_sampling_greedy_rows_and_filters(mode):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 3, (6, 300)).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0, 1.3, 0.9])
    top_k = torch.tensor([0, 3, 0, 5, 1, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.5, 1.0, 1.0, 1e-6])
    if mode == "greedy":
        temps = torch.zeros(6)
    gen = torch.Generator().manual_seed(0)
    out = tsampling.sample_batch(logits, gen, temps, top_k, top_p, mode=mode)
    ref = np.asarray(jsampling.sample_batch(
        jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
        jnp.asarray(temps.numpy()), jnp.asarray(top_k.numpy()),
        jnp.asarray(top_p.numpy()), mode=mode))
    assert out.dtype == torch.int32 and out.shape == (6,)
    greedy = (temps <= 0).numpy()
    np.testing.assert_array_equal(out.numpy()[greedy], ref[greedy])
    order = np.argsort(-logits.numpy(), axis=-1)
    if mode in ("topk", "full"):
        assert out[1] in order[1, :3] and out[4] == order[4, 0]
    if mode == "full":
        assert out[5] == order[5, 0]            # top_p -> the top token


def test_pick_sample_mode_matches_jax():
    cases = [[], [(0.0, 0, 1.0)], [(0.7, 0, 1.0)], [(0.7, 40, 1.0)],
             [(0.0, 0, 1.0), (1.0, 200, 1.0)], [(1.0, 0, 0.9)]]
    for case in cases:
        t = [tsampling.SamplingParams(*c) for c in case]
        j = [jsampling.SamplingParams(*c) for c in case]
        assert tsampling.pick_sample_mode(t) == jsampling.pick_sample_mode(j)


def test_block_manager_matches_jax_python_backend():
    ops = [("ensure", 0, 20), ("ensure", 1, 5), ("ensure", 0, 40),
           ("release", 1, 0), ("ensure", 2, 33), ("ensure", 1, 1),
           ("ensure", 1, 4 * PS), ("ensure", 0, 4 * PS)]
    j = jbm.BlockManager(12, PS, 3, 4, use_native=False)
    t = tbm.BlockManager(12, PS, 3, 4)
    for op, slot, n in ops:
        if op == "ensure":
            np.testing.assert_array_equal(t.ensure(slot, n), j.ensure(slot, n))
        else:
            t.release(slot)
            j.release(slot)
        assert t.num_free == j.num_free
    with pytest.raises(RuntimeError):
        t.ensure(0, 5 * PS)                      # over the per-seq cap
    assert t.num_free == 0
    with pytest.raises(RuntimeError):
        t.ensure(2, 4 * PS)                      # pool exhausted
    np.testing.assert_array_equal(t.table_row(2), j.table_row(2))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_make_cache_defaults_to_cuda(monkeypatch):
    """``make_cache`` without a device asks for the GPU and raises where
    there is none; ``device="cpu"`` still gives a CPU cache."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.make_cache(4, PS, 2, 16, 2, MP)
    cache = tkv.make_cache(4, PS, 2, 16, 2, MP, device="cpu")
    assert all(t.device.type == "cpu" for t in
               (cache.k_codes, cache.v_sz, cache.page_table, cache.lengths))


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import micromix_tpu_torch, micromix_tpu_torch.convert\n"
        "import micromix_tpu_torch.serve, micromix_tpu_torch.models\n"
        "import micromix_tpu_torch.serve.speculative\n"
        "import micromix_tpu_torch.serve.prefix_cache\n"
        "import micromix_tpu_torch.kernels, micromix_tpu_torch.ops\n"
        "import micromix_tpu_torch.parallel.spmd, micromix_tpu_torch.parallel.pp\n"
        "import micromix_tpu_torch.parallel.sp, micromix_tpu_torch.parallel.mesh\n"
        "import micromix_tpu_torch.parallel.api_ranks\n"
        "bad = [m for m in sys.modules if m == 'micromix_tpu'\n"
        "       or m.startswith('micromix_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_imports_nothing_of_jax():
    """Every module chip_smoke.py imports, at the top or inside a phase,
    imports with jax blocked and loads no module of the JAX package."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = sorted({a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                   for a in n.names}
                  | {n.module for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0})
    assert "micromix_tpu_torch.serve.engine" in mods
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'micromix_tpu'\n"
        "       or m.startswith(('micromix_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
