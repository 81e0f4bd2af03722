"""Port parity: public names the JAX package exports,
``models.identity_calibration`` and ``serve.sample``.

* ``identity_calibration``: equal to JAX's field by field (the order's
  values and dtype, the budgets) over several widths and budgets.
* ``sample``: greedy rows equal JAX's argmax; sampled rows (temperature,
  top-k, top-p, both) equal JAX's ``sample`` for a key when the port is
  handed JAX's own Gumbel noise for that key (``jax.random.gumbel``, what
  ``jax.random.categorical`` adds), so both take the argmax of the same
  sums.  Tolerance: token ids equal.  The logits are random normals in
  f32, where the filters' cut-offs and the argmax have no ties.
"""

import numpy as np

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
