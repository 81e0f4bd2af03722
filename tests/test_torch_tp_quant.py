"""Port parity: tensor parallelism v2 (``parallel/tp_quant.py``,
``parallel/tp_hetero.py``) and Kernels B and K with f32 output, against
the JAX package on the CPU (conftest's 8 CPU devices, a mesh of 2).

* ``split_site_calibration`` and ``_hetero``: equal to JAX's over
  several (k, tp, budgets), shard orders and budgets both.
* ``quantize_model_tp`` (ScaledW8, with one o weight whose shards'
  common base overflows, so that weight falls back to split-plane on
  every shard), with ``weight_fp4_only=False`` (split-plane everywhere)
  and ``quantize_model_tp_hetero``: the port's global trees bit-exact
  against JAX's, converted; each of 2 gloo ranks' own tree, quantized
  from its shards with one all_reduce(MIN) and one all_reduce(MAX) a
  weight, bit-exact against the global tree's slice
  (``shard_params_tp``).
* ``sharded_forward_tp`` / ``_hetero`` on 2 ranks against JAX's
  ``sharded_forward_tp`` / ``_hetero`` on the mesh, JAX's attention
  pointed at its flash kernel (interpret mode) as the port's prefill runs
  Kernel E's plain version.
* B's and K's plain versions with ``out_dtype=float32`` against JAX's
  ``mixed_matmul(..., out_dtype=jnp.float32)`` in interpret mode.
* What a spawned rank imports imports neither jax nor micromix_tpu.

Tolerances:
  * calibrations, codes, bases, perms, block formats, biases: bit-exact;
  * f32 GEMM outputs: the same exact products summed in another order,
    each side within K 2^-24 (|A| |W|^T) of the exact sum;
  * forward logits: within 2% of max |logit| (the port's forward-parity
    band, tests/test_torch_hetero.py), argmax equal at every position;
    the ranks' logits bit-equal (the sums come out replicated).  JAX's
    rms sites and final norm take tests/jax_rounding.py's barriers on
    their inputs (``jax_tp_rounds``), so its CPU backend rounds the
    residual sums to bf16 where its program states it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_ranks
from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_checkpoint import _assert_port_trees_equal

from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.kernels.mixed_matmul import mixed_matmul as j_mm
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.mx.mxtensor import MixedTensor as JMixed
from micromix_tpu.mx.scaledw8 import ScaledW8 as JW8
from micromix_tpu.parallel import make_mesh
from micromix_tpu.parallel import tp_hetero as jtph
from micromix_tpu.parallel import tp_quant as jtpq
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.kernels.fakequant import fakequant_values
from micromix_tpu_torch.kernels.mixed_matmul import (mixed_matmul_sp_plain,
                                                     mixed_matmul_w8_plain)
from micromix_tpu_torch.kernels.quantize import quantize_mixed as t_act_quant
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import DenseLinear, ModelConfig
from micromix_tpu_torch.mx.mxtensor import dequantize_mixed_device, quantize_mixed
from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8, pack_scaled_w8
from micromix_tpu_torch.parallel import (quantize_model_tp,
                                         quantize_model_tp_hetero, spawn,
                                         split_site_calibration,
                                         split_site_calibration_hetero)
from micromix_tpu_torch.parallel.tp_quant import shard_params_tp

TP = 2
# every column-parallel weight (256, 256) and every K shard (256, 128):
# JAX's eager quantizers compile once a shape (5-15 s each here)
CFG = dict(arch="llama", vocab_size=256, hidden_size=256,
           intermediate_size=256, num_layers=1, num_heads=4, num_kv_heads=4,
           head_dim=64, rope_theta=10000.0, rms_eps=1e-6)
# the o weight's first K shard scaled by 2^-70: each shard's exponent span
# fits ScaledW8's field alone, their common base does not
OVERFLOW = 2.0 ** -70


def _models(overflow: bool):
    """(jcfg, tcfg, jdense, tdense, jcalibs, tcalibs): one layer, the same
    dense weights and seeded calibration with FP6 / FP8 budgets in both
    packages."""
    jcfg = jcommon.ModelConfig(**CFG)
    tcfg = ModelConfig(**CFG)
    jd = jsurg.random_dense_params(jcfg, seed=21)
    td = tsurg.random_dense_params(tcfg, seed=21, device="cpu")
    if overflow:
        k_l = CFG["num_heads"] * CFG["head_dim"] // TP
        w = jd["layers"][0]["o"].w
        jd["layers"][0]["o"] = jcommon.DenseLinear(
            w=w.at[:, :k_l].multiply(OVERFLOW))
        tw = td["layers"][0]["o"].w.clone()
        tw[:, :k_l] *= OVERFLOW
        td["layers"][0]["o"] = DenseLinear(w=tw)
    jc = jsurg.default_calibration(jcfg, p6=64, p8=64, seed=4)
    tc = tsurg.default_calibration(tcfg, p6=64, p8=64, seed=4)
    return jcfg, tcfg, jd, td, jc, tc


@pytest.fixture
def jax_tp_rounds(monkeypatch):
    """tests/jax_rounding.py's barriers on the TP forwards' own imports:
    the residual sums into the rms sites and the final norm round to bf16
    where JAX's program states it (XLA's CPU backend may skip it)."""
    bar = jax.lax.optimization_barrier
    site, norm = jtph.rmsnorm_fakequant, jtpq.rmsnorm
    quant = jtpq.rmsnorm_quantize_x
    monkeypatch.setattr(jtph, "rmsnorm_fakequant",
                        lambda x, g, s, eps: site(bar(x), g, s, eps))
    monkeypatch.setattr(jtpq, "rmsnorm_quantize_x",
                        lambda x, *a, **kw: quant(bar(x), *a, **kw))
    for mod in (jtpq, jtph):
        monkeypatch.setattr(mod, "rmsnorm",
                            lambda x, g, eps: norm(bar(x), g, eps))


def _port(jtree, tcfg):
    return from_jax_params(jax.tree.map(np.asarray, jtree), tcfg, device="cpu")


def _jax_forward(fn, jtree, jcfg, tokens, monkeypatch, module):
    monkeypatch.setattr(module, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    mesh = make_mesh(data=1, model=TP, devices=jax.devices()[:TP])
    return np.asarray(fn(jtree, jcfg, jnp.asarray(tokens), mesh), np.float32)


def _check_ranks(ranks, tree, ref_logits):
    """Each rank's own tree equals the global tree's slice; the ranks'
    logits are equal and within the forward band of JAX's."""
    for rank, (local, n_reduce, logits) in enumerate(ranks):
        _assert_port_trees_equal(local, shard_params_tp(tree, rank, TP))
        # one MIN and one MAX a weight: 7 weights a layer
        assert n_reduce == 2 * 7
    assert np.array_equal(ranks[0][2], ranks[1][2])
    got = ranks[0][2]
    err = np.abs(got - ref_logits).max() / np.abs(ref_logits).max()
    assert err <= 0.02, err
    np.testing.assert_array_equal(got.argmax(-1), ref_logits.argmax(-1))


@pytest.mark.parametrize("k,tp,p6,p8,seed", [
    (256, 2, 128, 128, 0), (256, 2, 0, 0, 1), (512, 2, 128, 0, 2),
    (512, 4, 128, 128, 3), (1024, 2, 256, 128, 4), (1024, 4, 384, 256, 5),
    (4096, 2, 256, 256, 6), (4096, 8, 512, 256, 7)])
def test_split_site_calibrations_match_jax(k, tp, p6, p8, seed):
    order = np.random.default_rng(seed).permutation(k).astype(np.int32)
    jc = jsurg.SiteCalibration(order, p6, p8)
    tc = tsurg.SiteCalibration(order, p6, p8)
    for jfn, tfn in ((jtpq.split_site_calibration, split_site_calibration),
                     (jtph.split_site_calibration_hetero,
                      split_site_calibration_hetero)):
        for j, t in zip(jfn(jc, k, tp), tfn(tc, k, tp), strict=True):
            np.testing.assert_array_equal(j.reorder_index, t.reorder_index)
            assert (j.p6_num, j.p8_num) == (t.p6_num, t.p8_num)


def test_quantize_model_tp_and_forward_match_jax(monkeypatch, jax_tp_rounds):
    """ScaledW8 TP, one o weight falling back to split-plane (its common
    base overflows): global trees bit-exact, ranks' own trees equal the
    slices, the 2-rank forward against JAX's."""
    jcfg, tcfg, jd, td, jc, tc = _models(overflow=True)
    jtree = jtpq.quantize_model_tp(jd, jcfg, jc, TP)
    tree = quantize_model_tp(td, tcfg, tc, TP)
    _assert_port_trees_equal(tree, _port(jtree, tcfg))
    layer = tree["layers"][0]
    assert type(layer["o"].w).__name__ == "MixedTensor"      # the fallback
    assert type(layer["down"].w).__name__ == "ScaledW8"
    tokens = np.random.default_rng(3).integers(0, CFG["vocab_size"], (1, 24))
    ref = _jax_forward(jtpq.sharded_forward_tp, jtree, jcfg, tokens,
                       monkeypatch, jtpq)
    ranks = spawn(torch_ranks.tp_quant_and_forward, TP, td, tree, tcfg, tc,
                  tokens, False, True, device="cpu")
    _check_ranks(ranks, tree, ref)


def test_split_plane_tp_and_f32_products_match_jax():
    """``weight_fp4_only=False``: every weight split-plane, bit-exact
    against JAX's; and B's and K's plain versions with f32 output against
    JAX's mixed_matmul(out_dtype=float32) in interpret mode."""
    jcfg, tcfg, jd, td, jc, tc = _models(overflow=False)
    jtree = jtpq.quantize_model_tp(jd, jcfg, jc, TP, weight_fp4_only=False)
    tree = quantize_model_tp(td, tcfg, tc, TP, weight_fp4_only=False)
    _assert_port_trees_equal(tree, _port(jtree, tcfg))
    assert all(type(v.w).__name__ == "MixedTensor"
               for k, v in tree["layers"][0].items() if k in ("q", "o", "down"))
    ranks = spawn(torch_ranks.tp_quant_and_forward, TP, td, tree, tcfg, tc,
                  None, False, False, device="cpu")
    for rank, (local, _, _) in enumerate(ranks):
        _assert_port_trees_equal(local, shard_params_tp(tree, rank, TP))

    rng = np.random.default_rng(9)
    splits, m, n = (256, 128, 128), 8, 64
    k = sum(splits)
    torch.manual_seed(9)
    w8 = pack_scaled_w8(quantize_mixed(torch.randn(n, k) * 0.05, *splits,
                                       weight_fp4_only=True))
    a = fakequant_values(torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)),
                         *splits)
    jw8 = JW8(codes=jnp.asarray(w8.codes.numpy()),
              base=jnp.full((1, 1), w8.base, jnp.int32), k4=256, k6=128, k8=128)
    ja = jnp.asarray(a.to(torch.float32).numpy(), jnp.bfloat16)
    ref = np.asarray(j_mm(ja, jw8, out_dtype=jnp.float32, interpret=True))
    got = mixed_matmul_w8_plain(a, w8, torch.float32)
    assert got.dtype == torch.float32
    _assert_f32_close(got.numpy(), ref, a, dequantize_scaled_w8(w8, torch.float32))

    wsp = quantize_mixed(torch.randn(n, k) * 0.05, *splits, weight_fp4_only=False,
                         pack_fp4=True)
    asp = t_act_quant(torch.randn(m, k).to(torch.bfloat16), *splits)
    fields = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")

    def jmixed(t):
        return JMixed(**{f: jnp.asarray(getattr(t, f).numpy()) for f in fields},
                      fp4_packed=t.fp4_packed, fp4_only=t.fp4_only)
    ref = np.asarray(j_mm(jmixed(asp), jmixed(wsp), out_dtype=jnp.float32,
                          interpret=True))
    got = mixed_matmul_sp_plain(asp, wsp, torch.float32)
    _assert_f32_close(got.numpy(), ref, dequantize_mixed_device(asp, torch.float32),
                      dequantize_mixed_device(wsp, torch.float32))


def _assert_f32_close(got, ref, a, w):
    bound = 2 * a.shape[1] * 2.0 ** -24 * (a.abs().float() @ w.abs().float().t()).numpy()
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def test_hetero_tp_and_forward_match_jax(monkeypatch, jax_tp_rounds):
    """The hetero form: global tree bit-exact, ranks' own trees equal the
    slices, the 2-rank forward against JAX's ``sharded_forward_tp_hetero``."""
    jcfg, tcfg, jd, td, jc, tc = _models(overflow=False)
    jtree = jtph.quantize_model_tp_hetero(jd, jcfg, jc, TP)
    tree = quantize_model_tp_hetero(td, tcfg, tc, TP)
    _assert_port_trees_equal(tree, _port(jtree, tcfg))
    fmt = tree["layers"][0]["o_site"].block_fmt
    assert fmt.shape == (CFG["num_heads"] * CFG["head_dim"] // 32,)
    tokens = np.random.default_rng(5).integers(0, CFG["vocab_size"], (1, 24))
    ref = _jax_forward(jtph.sharded_forward_tp_hetero, jtree, jcfg, tokens,
                       monkeypatch, jtph)
    ranks = spawn(torch_ranks.tp_quant_and_forward, TP, td, tree, tcfg, tc,
                  tokens, True, True, device="cpu")
    _check_ranks(ranks, tree, ref)



def test_rank_modules_import_without_jax():
    """What a spawned rank imports (the parallel package, the CLI's rank
    function, the tests' rank functions, chip_smoke's phase 12) imports
    neither jax nor micromix_tpu: a fresh interpreter with both blocked."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "for m in ('jax', 'micromix_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.path[:0] = ['tests', '.']\n"
            "import micromix_tpu_torch.parallel, micromix_tpu_torch.cli\n"
            "import torch_ranks, chip_smoke\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
