"""Port parity: the native host libraries (``utils/native.py`` over the
port's own copies of ``mxpack.cpp`` and ``kvpool.cpp`` in
``micromix_tpu_torch/csrc/host/``), held against the JAX package's
(``micromix_tpu.utils.native`` and the native core of
``micromix_tpu.serve.block_manager``) and against the port's torch
quantizers and Python page pool, on the CPU.

Tolerances: none.  Codes, scales, bases, page-table rows and free counts
are compared bit for bit.  The port builds its libraries into
``build/host/`` and writes nothing under the JAX package's ``native/``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import ModelConfig as JModelConfig
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.mx import scaledw8 as jsw8
from micromix_tpu.serve import block_manager as jbm
from micromix_tpu.utils import native as jnative
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.mx import scaledw8 as tsw8
from micromix_tpu_torch.mx.mxtensor import MixedTensor, quantize_mixed
from micromix_tpu_torch.serve import block_manager as tbm
from micromix_tpu_torch.utils import native as tnative

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")
# (k4, k6, k8) over K = 512
SPLITS = ((512, 0, 0), (384, 64, 64), (256, 128, 128), (0, 256, 256),
          (128, 0, 384))


def _native_files():
    """Name, size and mtime of every file under ``native/``."""
    out = {}
    for root, _, files in os.walk(NATIVE_DIR):
        for f in files:
            st = os.stat(os.path.join(root, f))
            out[os.path.join(root, f)] = (st.st_size, st.st_mtime_ns)
    return out


def _weight(rng, rows, k, wide=False):
    """Weights whose scaled blocks stay f32 normals (XLA's CPU flushes
    subnormals, IEEE arithmetic does not); ``wide``: one row spanning
    2^-60 .. 2^40, past ScaledW8's 62-exponent span."""
    w = rng.normal(0, 1, (rows, k)).astype(np.float32)
    if wide:
        w[0, :32] *= 2.0 ** -60
        w[0, 32:64] *= 2.0 ** 40
    return w


def test_host_quantizers_match_jax_and_torch():
    """``quantize_mixed_host`` (both weight grids) and
    ``quantize_scaledw8_host`` over five segment splits: the port's
    library against JAX's, and the segments against the port's torch
    ``quantize_mixed(pack_fp4=True)``; ScaledW8 codes and base against the
    torch pack of the same segments; a layout past the 62-exponent span
    gives None from both libraries.  The port's calls leave ``native/``
    as it was."""
    rng = np.random.default_rng(0)
    before = _native_files()
    port = {}
    for k4, k6, k8 in SPLITS:
        w = _weight(rng, 48, k4 + k6 + k8)
        for fp4_only in (True, False):
            port[(k4, k6, k8, fp4_only)] = (w, tnative.quantize_mixed_host(
                w, k4, k6, k8, weight_fp4_only=fp4_only))
        port[(k4, k6, k8, "w8")] = (w, tnative.quantize_scaledw8_host(
            w, k4, k6, k8, n_threads=3))
    wide = _weight(rng, 8, 512, wide=True)
    assert tnative.quantize_scaledw8_host(wide, 512, 0, 0) is None
    assert tnative.native_available()
    assert _native_files() == before, "the port wrote under native/"
    assert jnative.quantize_scaledw8_host(wide, 512, 0, 0) is None
    for key, (w, got) in port.items():
        k4, k6, k8, mode = key
        if mode == "w8":
            codes, base = got
            jcodes, jbase = jnative.quantize_scaledw8_host(w, k4, k6, k8)
            np.testing.assert_array_equal(codes, jcodes, err_msg=str(key))
            assert base == jbase, key
            t = quantize_mixed(torch.from_numpy(w), k4, k6, k8,
                               weight_fp4_only=True, pack_fp4=True)
            sw = tsw8.pack_scaled_w8(t)
            np.testing.assert_array_equal(codes, sw.codes.numpy(), err_msg=str(key))
            assert base == sw.base, key
            continue
        ref = jnative.quantize_mixed_host(w, k4, k6, k8, weight_fp4_only=mode)
        t = quantize_mixed(torch.from_numpy(w), k4, k6, k8,
                           weight_fp4_only=mode, pack_fp4=True)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f"{key} {f}")
            np.testing.assert_array_equal(got[f], getattr(t, f).numpy(),
                                          err_msg=f"{key} {f} torch")


def test_pack_and_host_surgery_match_jax():
    """``pack_scaled_w8_host`` equals JAX's on the same host segments
    (codes and base), and raises where JAX's does (the wide row); a
    biased row-permuted linear equals JAX's, its bias permuted too, the
    split-plane routes equal the torch quantizer's, a weight off the host
    is refused; then
    ``quantize_model(host=True)`` of a 2-layer Qwen2 (q/k/v biases, gate
    and up row-permuted) equals JAX's
    ``quantize_model(host=True)`` carried across by
    ``convert.from_jax_params``, and the port's own device quantizer."""
    rng = np.random.default_rng(1)
    for k4, k6, k8 in SPLITS[:3]:
        segs = jnative.quantize_mixed_host(_weight(rng, 32, 512), k4, k6, k8,
                                           weight_fp4_only=True)
        got, ref = tsw8.pack_scaled_w8_host(segs, k4, k6, k8), \
            jsw8.pack_scaled_w8_host(segs, k4, k6, k8)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
        assert got.base == int(np.asarray(ref.base)[0, 0])
    segs = jnative.quantize_mixed_host(_weight(rng, 8, 512, wide=True), 512, 0, 0,
                                       weight_fp4_only=True)
    for pack in (tsw8.pack_scaled_w8_host, jsw8.pack_scaled_w8_host):
        with pytest.raises(ValueError):
            pack(segs, 512, 0, 0)
    # a biased row-permuted linear: its bias takes the rows' permutation
    w = rng.normal(0, 1, (64, 256)).astype(np.float32)
    bias = rng.normal(0, 0.01, 64).astype(np.float32)
    perm, rows = rng.permutation(256).astype(np.int32), rng.permutation(64)
    jl = jsurg.quantize_linear(jnp.asarray(w), jsurg.SiteCalibration(perm, 64, 64),
                               jnp.asarray(bias, jnp.bfloat16), row_perm=rows,
                               host=True)
    tl = tsurg.quantize_linear(torch.from_numpy(w), tsurg.SiteCalibration(perm, 64, 64),
                               torch.from_numpy(bias).to(torch.bfloat16),
                               row_perm=rows, host=True)
    np.testing.assert_array_equal(tl.w.codes.numpy(), np.asarray(jl.w.codes))
    np.testing.assert_array_equal(tl.bias.view(torch.int16).numpy(),
                                  np.asarray(jl.bias).view(np.int16))
    # the split-plane routes (MXFP4/6/8 segments; an all-MXFP4 weight past
    # the 62-exponent span) equal the torch quantizer's; host=True takes
    # weights held in host memory only
    cal = tsurg.SiteCalibration(np.arange(512, dtype=np.int32), 64, 64)
    for w, fp4_only in ((_weight(rng, 16, 512), False),
                        (_weight(rng, 8, 512, wide=True), True)):
        got = tsurg.quantize_linear(torch.from_numpy(w), cal, host=True,
                                    weight_fp4_only=fp4_only).w
        ref = tsurg.quantize_linear(torch.from_numpy(w), cal,
                                    weight_fp4_only=fp4_only).w
        assert type(got) is type(ref) is MixedTensor and got.fp4_packed
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    with pytest.raises(ValueError, match="host memory"):
        tsurg.quantize_linear(torch.empty(8, 512, device="meta"), cal, host=True)
    base = dict(arch="qwen2", vocab_size=128, hidden_size=256,
                intermediate_size=512, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=64, rope_theta=1e6, rms_eps=1e-6,
                qkv_bias=True)
    jcfg, tcfg = JModelConfig(**base), ModelConfig(**base)
    calib = jsurg.default_calibration(jcfg, p6=64, p8=64, seed=2)
    jq = jsurg.quantize_model(jsurg.random_dense_params(jcfg, seed=2), jcfg,
                              calib, host=True)
    ref = from_jax_params(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    dense = tsurg.random_dense_params(tcfg, seed=2, device="cpu")
    tcal = tsurg.default_calibration(tcfg, p6=64, p8=64, seed=2)
    for got in (tsurg.quantize_model(dense, tcfg, tcal, host=True),
                tsurg.quantize_model(dense, tcfg, tcal)):
        for lg, lr in zip(got["layers"], ref["layers"]):
            for name in ("q", "k", "v", "o", "gate", "up", "down"):
                wg, wr = lg[name].w, lr[name].w
                assert torch.equal(wg.codes, wr.codes) and wg.base == wr.base, name
                assert (lg[name].bias is None) == (lr[name].bias is None), name
                if lg[name].bias is not None:
                    assert torch.equal(lg[name].bias.view(torch.int16),
                                       lr[name].bias.view(torch.int16)), name
            for site in ("attn_site", "o_site", "mlp_site"):
                assert torch.equal(lg[site].perm.long(), lr[site].perm.long())


def test_native_page_pool_matches_jax_and_python():
    """A seeded run of ``ensure`` and ``release`` over 6 slots and 40
    pages, exhaustion and the per-sequence cap among them: after every
    call the port's native core, the port's Python pool and JAX's native
    core give the same page-table rows, page counts, free counts and
    raised errors; a slot outside the pool raises IndexError in both of
    the port's pools; the port's build leaves ``native/`` as it was."""
    before = _native_files()
    ps, slots, pages, cap = 16, 6, 40, 10
    native = tbm.NativeBlockManager(pages, ps, slots, cap)
    python = tbm.BlockManager(pages, ps, slots, cap)
    assert native.is_native and not python.is_native
    for p in (native, python):
        for bad in (-1, slots):
            for call in (lambda: p.ensure(bad, 1), lambda: p.release(bad),
                         lambda: p.table_row(bad), lambda: p.num_pages(bad)):
                with pytest.raises(IndexError):
                    call()
    assert tbm.native_kvpool_available()
    assert _native_files() == before, "the port wrote under native/"
    jax_pool = jbm.BlockManager(pages, ps, slots, cap, use_native=True)
    pools = (native, python, jax_pool)
    rng = np.random.default_rng(3)
    raised = 0
    for _ in range(300):
        slot = int(rng.integers(0, slots))
        if rng.random() < 0.3:
            for p in pools:
                p.release(slot)
        else:
            tokens = int(rng.integers(1, cap * ps + 40))
            errs = []
            for p in pools:
                try:
                    p.ensure(slot, tokens)
                    errs.append(None)
                except RuntimeError as e:
                    errs.append(str(e))
            assert errs[0] == errs[1] == errs[2], errs
            raised += errs[0] is not None
        for s in range(slots):
            rows = [p.table_row(s) for p in pools]
            np.testing.assert_array_equal(rows[0], rows[2])
            np.testing.assert_array_equal(rows[1], rows[2])
            assert native.num_pages(s) == python.num_pages(s) == jax_pool.num_pages(s)
        assert native.num_free == python.num_free == jax_pool.num_free
    assert raised > 10
