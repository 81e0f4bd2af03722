"""Port parity: pipeline parallelism (``parallel/pp.py``) and sequence
parallelism (``parallel/sp.py``: gather, ring, Ulysses) on CPU gloo
ranks, against the JAX package's ``pipeline_parallel_forward`` and
``sequence_parallel_forward`` on conftest's CPU devices.

Models: ``tests/test_sp_pp.py``'s and ``tests/test_hetero.py``'s widths
(hidden 128, head_dim 32, 4 / 2 heads, 4 heads a KV head for Ulysses at
sp=4), the same numpy draws in both packages; the quantized model is the
hetero form (budgets as data, so the layers' budgets differ and still
stack), quantized once by JAX (``quantize_model_hetero``, under a second
here against 44 s for JAX's eager ``quantize_model``) and carried across
by ``convert.from_jax_params``.

* PP at 2 stages, dense and hetero, against JAX's (``use_flash=True``:
  its flash kernel interprets on the CPU; its XLA attention would round
  the probabilities to bf16, the port's stages run Kernel E's plain
  version, f32); the hetero 1-stage (``n_micro=1``) and 2-stage
  (``n_micro=2``) logits bit-equal, JAX's lock
  (tests/test_hetero.py:79-106); ``stack_layers`` stacks the hetero
  layers' different budgets and refuses segmented layers of different
  budgets, as JAX's one-treedef stack does.
* SP gather, ring and Ulysses at sp=2 (GQA, and a 12-token window that
  crosses the 8-token shards) and at sp=4, dense; gather and ring on the
  hetero model; each rank's sequence shard against JAX's.

Tolerances (the logits span about 1 here):
  * ``CLOSE``, 1e-5 of max |logit|, argmax equal: gather and Ulysses
    (dense and hetero), and every hetero run.  The same rounding points
    on both sides; only the order of f32 sums differs (XLA against ATen):
    measured 1.4e-7 to 2.2e-7.
  * ``JAX_BAND``, JAX's own band for these forwards (rtol = atol = 2e-2,
    tests/test_sp_pp.py), argmax equal: the dense runs whose attention
    keeps f32 probabilities (PP's flash attention, the ring).  XLA's CPU
    exp and ATen's differ in the last f32 bits; the attention output's
    bf16 round then moves by an ulp now and then, and 4 bf16 layers carry
    that to the logits: measured 3.7e-3 to 8.4e-3 of max |logit|.  A
    hetero site absorbs such differences (its block quantization), so
    the hetero runs stay ``CLOSE``.
  * PP 1-stage against 2-stage: bit-equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_ranks
from jax_rounding import jax_rounds_bf16  # noqa: F401 (fixture)
from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import ModelConfig as JConfig
from micromix_tpu.models import random_dense_params as j_dense
from micromix_tpu.models.hetero import quantize_model_hetero as j_hetero
from micromix_tpu.models.surgery import SiteCalibration as JCalib
from micromix_tpu.models.surgery import default_calibration as j_default
from micromix_tpu.parallel import (make_mesh, make_pp_mesh,
                                   pipeline_parallel_forward,
                                   sequence_parallel_forward)
from micromix_tpu.parallel import pp as jpp
from micromix_tpu.parallel import sp as jsp
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.models.surgery import (default_calibration,
                                               quantize_model,
                                               random_dense_params)
from micromix_tpu_torch.parallel import spawn, stack_layers
from micromix_tpu_torch.parallel.pp import layer_of

CFG = dict(arch="llama", vocab_size=128, hidden_size=128,
           intermediate_size=256, num_layers=4, num_heads=4, num_kv_heads=2,
           head_dim=32, rope_theta=10000.0, rms_eps=1e-6)
BUDGETS = [(0, 0), (32, 32), (64, 32), (32, 64)]      # a layer's (p6, p8)
CLOSE, JAX_BAND = "close", "jax band"


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX dense, port dense, JAX hetero, port
    hetero): the seeded dense model and its hetero form, each layer at
    its own budgets (tests/test_hetero.py's _hetero_calibs)."""
    jcfg, tcfg = JConfig(**CFG), ModelConfig(**CFG)
    jd = j_dense(jcfg, seed=9)
    calibs = j_default(jcfg, seed=0)
    for i, c in enumerate(calibs):
        for k in c:
            c[k] = JCalib(c[k].reorder_index, *BUDGETS[i % len(BUDGETS)])
    jh = j_hetero(jd, jcfg, calibs)
    th = from_jax_params(jax.tree.map(np.asarray, jh), tcfg, device="cpu")
    return jcfg, tcfg, jd, random_dense_params(tcfg, seed=9, device="cpu"), jh, th


@pytest.fixture
def jax_sp_pp_rounds(monkeypatch, jax_rounds_bf16):  # noqa: F811
    """tests/jax_rounding.py's barriers, and the same on the final norms
    that pp.py and sp.py import themselves."""
    bar, norm = jax.lax.optimization_barrier, jsp.rmsnorm
    for mod in (jsp, jpp):
        monkeypatch.setattr(mod, "rmsnorm", lambda x, g, eps: norm(bar(x), g, eps))


def _check(got, ref, tol, what):
    if tol == CLOSE:
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= 1e-5, (what, err)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2,
                                   err_msg=str(what))
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1), str(what))


def test_pp_matches_jax_and_one_stage(models, jax_sp_pp_rounds):
    """2 stages against JAX's, dense and hetero; hetero 1 stage bit-equal
    to 2 stages."""
    jcfg, tcfg, jd, td, jh, th = models
    tokens = np.random.default_rng(3).integers(0, CFG["vocab_size"], (4, 16))
    mesh = make_pp_mesh(2, devices=jax.devices()[:2])
    for name, jp, tp, tol in (("dense", jd, td, JAX_BAND),
                              ("hetero", jh, th, CLOSE)):
        ref = np.asarray(pipeline_parallel_forward(
            jp, jcfg, jnp.asarray(tokens, jnp.int32), mesh, n_micro=2,
            use_flash=True), np.float32)
        two = spawn(torch_ranks.pp_forward, 2, tp, tcfg, tokens, 2, device="cpu")
        assert np.array_equal(two[0], two[1])      # the head runs on every rank
        _check(two[0], ref, tol, f"pp {name}")
    one = spawn(torch_ranks.pp_forward, 1, th, tcfg, tokens, 1, device="cpu")
    np.testing.assert_array_equal(one[0], two[0])


def test_sp_variants_match_jax(models, jax_sp_pp_rounds):
    """Gather, ring and Ulysses against JAX's: sp=2 (GQA, a window across
    the shard border) and sp=4 (4 heads a KV head: Ulysses needs sp | Hkv),
    dense; gather and ring on the hetero model at sp=2."""
    jcfg, tcfg, jd, td, jh, th = models
    tokens = np.random.default_rng(4).integers(0, CFG["vocab_size"], (1, 16))
    mha = dict(CFG, num_kv_heads=4)
    dense = {"gather": CLOSE, "ring": JAX_BAND, "ulysses": CLOSE}
    runs = [(2, jcfg, tcfg, jd, td, dense),
            (2, dataclasses.replace(jcfg, sliding_window=12),
             dataclasses.replace(tcfg, sliding_window=12), jd, td, dense),
            (2, jcfg, tcfg, jh, th, {"gather": CLOSE, "ring": CLOSE})]
    jm, tm = JConfig(**mha), ModelConfig(**mha)
    runs.append((4, jm, tm, j_dense(jm, seed=10),
                 random_dense_params(tm, seed=10, device="cpu"), dense))
    for sp, jc, tc, jp, tp, tols in runs:
        mesh = make_mesh(seq=sp, devices=jax.devices()[:sp])
        ranks = spawn(torch_ranks.sp_forwards, sp, tp,
                      [(tc, tokens, a) for a in tols], device="cpu")
        for i, (attn, tol) in enumerate(tols.items()):
            ref = np.asarray(sequence_parallel_forward(
                jp, jc, jnp.asarray(tokens, jnp.int32), mesh, attn=attn),
                np.float32)
            got = np.concatenate([r[i] for r in ranks], axis=1)
            _check(got, ref, tol, (sp, jc.sliding_window, attn))


def test_stack_layers_takes_data_budgets_and_refuses_static_ones(models):
    """The hetero layers' budgets differ and stack (data); segmented layers
    of different budgets (static fields) are refused, as JAX's stack
    refuses two treedefs; a stacked layer is the layer."""
    _, tcfg, _, td, _, th = models
    st = stack_layers(th["layers"])
    assert st["q"].w.codes.shape[0] == CFG["num_layers"]
    for i, layer in enumerate(th["layers"]):
        got = layer_of(st, i)
        assert torch.equal(got["mlp_site"].block_fmt, layer["mlp_site"].block_fmt)
        assert got["down"].w.base == layer["down"].w.base
    calibs = default_calibration(tcfg, seed=0)
    for i, c in enumerate(calibs):
        for k, v in c.items():
            c[k] = dataclasses.replace(v, p6_num=BUDGETS[i][0],
                                       p8_num=BUDGETS[i][1])
    seg = quantize_model(td, tcfg, calibs)
    with pytest.raises(ValueError, match="layers differ"):
        stack_layers(seg["layers"])
    stack_layers(seg["layers"][:1])
