"""The JAX package's stated bf16 rounding points, kept on its CPU backend.

The JAX package's programs round to bf16 at some points that XLA's CPU
backend, which computes bf16 elementwise work in f32 and allows excess
precision, may skip where a bf16 value feeds a fused consumer that widens
it again.  On the hetero site's input (a residual sum ``h + o``), on
``rmsnorm``'s input and on ``Int8TurboLinear``'s input that moves
quantization and int8 rounding decisions, and greedy paths of the two
packages part (unpatched: 13 of 1792 elements of the hetero Llama's first
MLP site image move; the weight-only MXFP8 model's greedy path parts at
its 7th token).  This fixture puts an optimization barrier on those
inputs in the JAX package's functions, so its reference rounds where its
program states and the port, which rounds there, is held to it: the
greedy-token parity of the tests that request it holds against this
patched reference.  Nothing in ``micromix_tpu/`` changes.  A port test
file that needs it imports it (autouse is off: request it by name).
"""

import jax
import pytest

from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import common as jcommon
from micromix_tpu.models import hetero as jhet
from micromix_tpu.models import transformer as jtr
from micromix_tpu.serve import runner as jrunner


@pytest.fixture
def jax_rounds_bf16(monkeypatch):
    """Barriers on the inputs named above, and JAX's prefill attention on
    its flash kernel (the port's runs Kernel E's plain version; the JAX
    runner's CPU branch rounds the probabilities to bf16)."""
    bar = jax.lax.optimization_barrier
    site, norm = jhet.rmsnorm_fakequant, jcommon.rmsnorm
    int8_call = jcommon.Int8TurboLinear.__call__
    monkeypatch.setattr(jhet, "rmsnorm_fakequant",
                        lambda x, g, s, eps: site(bar(x), g, s, eps))
    for mod in (jcommon, jtr, jrunner):
        monkeypatch.setattr(mod, "rmsnorm", lambda x, g, eps: norm(bar(x), g, eps))
    monkeypatch.setattr(jcommon.Int8TurboLinear, "__call__",
                        lambda self, x: int8_call(self, bar(x)))
    monkeypatch.setattr(jrunner, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
