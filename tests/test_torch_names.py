"""Port parity: public names the JAX package exports,
``models.identity_calibration`` and ``serve.sample``.

* Every name of each JAX subpackage's ``__all__`` is in the port's
  counterpart's ``__all__`` and bound there, but for the names on
  ``NO_COUNTERPART``.  Where the port had the function under another
  name, the JAX name is bound to it (the same object).
* The MX names ported outright give JAX's values: ``FORMATS``,
  ``SEGMENT_ALIGN``, ``fakequant_blocks`` (bit-exact, inputs whose
  scaled members are f32 normals) and ``decode_packed_fp4`` (every byte).

* ``identity_calibration``: equal to JAX's field by field (the order's
  values and dtype, the budgets) over several widths and budgets.
* ``sample``: greedy rows equal JAX's argmax; sampled rows (temperature,
  top-k, top-p, both) equal JAX's ``sample`` for a key when the port is
  handed JAX's own Gumbel noise for that key (``jax.random.gumbel``, what
  ``jax.random.categorical`` adds), so both take the argmax of the same
  sums.  Tolerance: token ids equal.  The logits are random normals in
  f32, where the filters' cut-offs and the argmax have no ties.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models import identity_calibration as j_identity
from micromix_tpu.serve import sample as j_sample
from micromix_tpu.serve.sampling import SamplingParams as JParams
from micromix_tpu_torch.models import identity_calibration
from micromix_tpu_torch.serve import SamplingParams, sample


def test_identity_calibration_matches_jax():
    for k, p6, p8 in ((128, 0, 0), (4096, 256, 256), (14336, 512, 128)):
        want, got = j_identity(k, p6, p8), identity_calibration(k, p6, p8)
        np.testing.assert_array_equal(got.reorder_index, want.reorder_index)
        assert got.reorder_index.dtype == np.asarray(want.reorder_index).dtype
        assert (got.p6_num, got.p8_num) == (want.p6_num, want.p8_num)
        assert got.splits(k) == want.splits(k)


def test_sample_matches_jax_given_its_noise():
    for i, kw in enumerate((dict(), dict(temperature=0.8),
                            dict(temperature=0.7, top_k=20),
                            dict(temperature=1.1, top_p=0.9),
                            dict(temperature=0.9, top_k=50, top_p=0.8))):
        logits = np.random.default_rng(i).normal(0, 3, (6, 1000)).astype(
            np.float32)
        key = jax.random.PRNGKey(17 + i)
        want = np.asarray(j_sample(jnp.asarray(logits), key, JParams(**kw)))
        noise = torch.from_numpy(np.asarray(
            jax.random.gumbel(key, logits.shape, jnp.float32)))
        got = sample(torch.from_numpy(logits), params=SamplingParams(**kw),
                     gumbel=noise)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, str(kw))
        if not kw:
            np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


SUBPACKAGES = ("calib", "eval", "kernels", "models", "mx", "ops", "parallel",
               "serve", "utils")
# JAX names with no counterpart in the port
NO_COUNTERPART = {
    # sets XLA_FLAGS for an HLO dump: there is no XLA under the port
    "utils": ("hlo_dump_env",),
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_jax_public_names_are_exported(sub):
    jax_mod = importlib.import_module(f"micromix_tpu.{sub}")
    port = importlib.import_module(f"micromix_tpu_torch.{sub}")
    skip = NO_COUNTERPART.get(sub, ())
    missing = [n for n in jax_mod.__all__ if n not in skip
               and (n not in port.__all__ or not hasattr(port, n))]
    assert not missing, f"{sub}: {missing}"
    assert all(n not in port.__all__ for n in skip)


def test_jax_names_bound_to_the_port_functions():
    from micromix_tpu_torch import kernels, mx, ops, parallel, serve
    mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")
    from micromix_tpu_torch.serve import attention, kv_cache
    assert serve.paged_decode_attention_xla is attention.paged_decode_attention_plain
    assert serve.kv_dequantize is kv_cache.kv_dequantize_page
    assert mx.mixed_matmul_xla is mm.mixed_matmul_sp_plain
    assert ops.quantize_mixed_pallas is kernels.quantize_mixed
    assert ops.mixed_matmul is kernels.mixed_matmul
    assert parallel.make_mesh is parallel.make_pp_mesh is parallel.axis_groups


def test_mx_names_ported_outright_match_jax():
    from micromix_tpu import mx as jmx
    from micromix_tpu_torch import mx as tmx
    assert tmx.SEGMENT_ALIGN == jmx.SEGMENT_ALIGN
    assert list(tmx.FORMATS) == list(jmx.FORMATS)
    for name, fmt in tmx.FORMATS.items():
        j = jmx.FORMATS[name]
        assert (fmt.bits, fmt.exp_bits, fmt.mant_bits, fmt.emin, fmt.emax,
                fmt.max) == (j.bits, j.exp_bits, j.mant_bits, j.emin, j.emax,
                             j.max)
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 1, (6, 128)) * rng.gamma(1, 4, (6, 1))).astype(np.float32)
    for name in tmx.FORMATS:
        want = np.asarray(jmx.fakequant_blocks(jnp.asarray(x), jmx.FORMATS[name]))
        got = tmx.fakequant_blocks(torch.from_numpy(x), tmx.FORMATS[name])
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, name)
    packed = np.arange(256, dtype=np.uint8).reshape(2, 128)
    want = np.asarray(jmx.decode_packed_fp4(jnp.asarray(packed)))
    got = tmx.decode_packed_fp4(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), want)
