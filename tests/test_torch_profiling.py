"""The port's profiling helpers (``micromix_tpu_torch.utils.profiling``):
the counterparts of tests/test_profiling.py's first three tests, on the
CPU (``hlo_dump_env`` has no counterpart without XLA)."""

import json
import os

import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu_torch.utils import annotate, marginal_timer, trace


def test_annotate_names_a_range(tmp_path):
    """The computation is unchanged, and the range's name is in the trace."""
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("square"):
            y = torch.ones((4, 4)) * torch.ones((4, 4))
    assert float(y.sum()) == 16.0
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "square" for e in events)


def test_trace_writes_files(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    found = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert found, "no trace files written"


def test_marginal_timer_positive():
    x = torch.ones((32, 32))
    assert marginal_timer(lambda: x @ x, iters=8, reps=1) > 0
