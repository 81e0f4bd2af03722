"""The port's shell (``python -m micromix_tpu_torch.cli``) on the CPU.

* The WordLevel fixture of tests/test_cli.py through calibrate ->
  quantize -> eval -> serve, with int4 and int8 KV pages.
* The trained-BPE pipeline of tests/test_real_tokenizer_pipeline.py run
  by the port alone, its calibration statistics held against the JAX
  package's (the golden perplexity is not reproduced within its band:
  see that test).
* ``serve`` on a checkpoint baked by the JAX package's ``quantize``
  command prints the same greedy completions as the JAX package's
  ``serve`` on it.  The JAX prefill attention is pointed at its flash
  kernel, as the port's prefill runs Kernel E's plain version: the JAX
  runner's CPU branch (XLA attention) rounds the probabilities to bf16,
  which parts a near tie on this model (ROADMAP 3.2).
* Every flag whose path is not ported exits naming its ROADMAP.md item;
  ``--platform auto`` raises without a GPU.
* The shell's modules import without jax, micromix_tpu, ml_dtypes,
  safetensors and transformers (a subprocess with those blocked).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_cli import ckpt  # noqa: F401 (fixture: the WordLevel checkpoint)
from test_real_tokenizer_pipeline import (  # noqa: F401 (fixture)
    CORPUS, GOLDEN_QUANT_PPL, bpe_ckpt)
from test_torch_checkpoint import _assert_port_trees_equal

from micromix_tpu.cli import main as jax_main
from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.serve import runner as jrunner
from micromix_tpu_torch.cli import main
from micromix_tpu_torch.models.checkpoint import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ["--max-new-tokens", "6", "--max-seqs", "2", "--page-size", "16",
         "--decode-chunk", "2"]


def _run(argv, capsys):
    main(["--platform", "cpu"] + argv)
    return capsys.readouterr().out


def _serve_stats(out):
    return json.loads(out.strip().splitlines()[-1])


def test_cli_calibrate_quantize_eval_serve(ckpt, tmp_path, capsys):  # noqa: F811
    calib = str(tmp_path / "calib.npz")
    out = _run(["calibrate", "--model", ckpt, "--samples", "2", "--seqlen",
                "32", "--dataset", "synthetic", "--output", calib], capsys)
    assert os.path.exists(calib) and "average bits:" in out
    qdir = str(tmp_path / "quantized")
    _run(["quantize", "--model", ckpt, "--calibration", calib,
          "--output", qdir], capsys)
    with open(os.path.join(qdir, "manifest.json")) as f:
        assert json.load(f)["meta"]["source"] == ckpt
    out = _run(["eval", "--model", ckpt, "--quantized-ckpt", qdir,
                "--eval-ppl", "synthetic", "--seqlen", "32",
                "--log-dir", str(tmp_path / "results")], capsys)
    ppl = float(out.split("synthetic perplexity:")[1])
    assert np.isfinite(ppl) and ppl > 1.0
    with open(next((tmp_path / "results").iterdir())) as f:
        assert json.load(f)["ppl/synthetic"] == pytest.approx(ppl, rel=1e-4)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("w1 w2 w3\nw4 w5 w6 w7\n")
    for kv in ("4", "8"):
        out = _run(["serve", "--model", ckpt, "--quantized-ckpt", qdir,
                    "--prompts", str(prompts), "--kv-bits", kv] + SERVE, capsys)
        stats = _serve_stats(out)
        assert stats["requests"] == 2 and stats["decode_tokens"] > 0
        assert out.count("--- [") == 2
        for key in ("prefill_tokens", "preemptions", "wall_s",
                    "decode_tokens_per_s", "mean_ttft_ms", "phase_s"):
            assert key in stats


def test_bpe_pipeline_through_the_port_alone(bpe_ckpt, tmp_path, capsys,  # noqa: F811
                                            monkeypatch):
    """The trained-BPE pipeline by the port's CLI alone.  Its calibration
    statistics are held against the JAX package's on the same windows
    (JAX's attention pointed at its flash kernel) at the parity rule's
    bands (tests/test_torch_calib.py: absmax and saliency 4%, the
    below-threshold counts 0.5%, totals equal).  The golden quantized
    perplexity is not reproduced within its band: random weights give
    channels of near-equal saliency, whose order (the reorder index) a
    one-step bf16 difference of a dense linear's output permutes; the port
    lands at 452.23 against 450.21, and the JAX package itself at 451.17
    when its attention runs its flash kernel."""
    from transformers import AutoTokenizer
    from micromix_tpu.calib import stats as jstats
    from micromix_tpu.models import loader as jloader
    from micromix_tpu.models import transformer as jtr
    from micromix_tpu_torch.calib import load_calibration
    from micromix_tpu_torch.eval.datasets import get_loaders

    calib = str(tmp_path / "calib.npz")
    _run(["calibrate", "--model", bpe_ckpt, "--samples", "4", "--seqlen",
          "64", "--dataset", f"file:{CORPUS}", "--output", calib], capsys)
    qdir = str(tmp_path / "quantized")
    _run(["quantize", "--model", bpe_ckpt, "--calibration", calib,
          "--output", qdir], capsys)
    out = _run(["eval", "--model", bpe_ckpt, "--quantized-ckpt", qdir,
                "--eval-ppl", f"file:{CORPUS}", "--seqlen", "64",
                "--log-dir", str(tmp_path / "results")], capsys)
    line = [ln for ln in out.splitlines() if "perplexity:" in ln][-1]
    ppl = float(line.split("perplexity:")[1])
    assert np.isfinite(ppl) and 1.0 < ppl < 1.25 * GOLDEN_QUANT_PPL
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the paged cache stores keys\n"
                       "quantization maps wide values\n")
    stats = _serve_stats(_run(["serve", "--model", bpe_ckpt, "--quantized-ckpt",
                               qdir, "--prompts", str(prompts)] + SERVE, capsys))
    assert stats["requests"] == 2 and stats["decode_tokens"] > 0

    tok = AutoTokenizer.from_pretrained(bpe_ckpt, use_fast=True)
    windows, _ = get_loaders(f"file:{CORPUS}", tok, seqlen=64, nsamples=4)
    monkeypatch.setattr(jtr, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    ref = jstats.collect_calibration(jloader.load_dense_params(bpe_ckpt),
                                     jloader.config_from_hf(json.load(open(
                                         os.path.join(bpe_ckpt, "config.json")))),
                                     windows)
    z = np.load(calib)
    for key, st in ref.items():
        for f, rtol in (("absmax", 0.04), ("saliency", 0.04)):
            np.testing.assert_allclose(z[f"{f}/{key}"], st[f], rtol=rtol,
                                       err_msg=f"{key} {f}")
    assert len(load_calibration(calib)[0]) == 2


def test_serve_on_a_jax_baked_checkpoint(ckpt, tmp_path, capsys,  # noqa: F811
                                         monkeypatch):
    """The JAX package's quantize command bakes the checkpoint (from a
    calibration the port's calibrate wrote): the port's quantize command
    bakes the same tree from it, bit for bit, and both packages' serve
    print the same completions and token counts on the JAX one."""
    calib = str(tmp_path / "calib.npz")
    _run(["calibrate", "--model", ckpt, "--samples", "2", "--seqlen", "32",
          "--dataset", "synthetic", "--output", calib], capsys)
    qdir = str(tmp_path / "jax_quantized")
    jax_main(["quantize", "--model", ckpt, "--calibration", calib,
              "--output", qdir])
    pdir = str(tmp_path / "port_quantized")
    _run(["quantize", "--model", ckpt, "--calibration", calib,
          "--output", pdir], capsys)
    (jq, jcfg, _), (pq, pcfg, _) = (load_params(d, device="cpu")
                                    for d in (qdir, pdir))
    assert jcfg == pcfg
    _assert_port_trees_equal(pq, jq)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("w1 w2 w3\nw4 w5\n")
    argv = ["serve", "--model", ckpt, "--quantized-ckpt", qdir,
            "--prompts", str(prompts)] + SERVE
    capsys.readouterr()
    monkeypatch.setattr(jrunner, "attention",
                        lambda q, k, v, mask: j_flash(q, k, v, interpret=True))
    jax_main(argv)
    ref = capsys.readouterr().out.strip().splitlines()
    got = _run(argv, capsys).strip().splitlines()
    assert got[:-1] == ref[:-1]
    assert any(ln.strip() and not ln.startswith("---") for ln in got[:-1])
    gs, rs = json.loads(got[-1]), json.loads(ref[-1])
    for key in ("requests", "prefill_tokens", "decode_tokens", "preemptions"):
        assert gs[key] == rs[key], key


REFUSED = [
    ("serve", ["--tp", "2"], "item 9"), ("serve", ["--ep", "2"], "item 9"),
    ("quantize", ["--hetero"], "item 8"),
    ("eval", ["--weight-only", "mxfp8"], "item 8"),
    ("quantize", ["--int8-turbo"], "item 8"),
    ("serve", ["--draft-model", "x"], "item 7"),
    ("serve", ["--spec-ngram", "2"], "item 7"),
    ("serve", ["--prefix-cache"], "item 6"),
    ("serve", ["--profile", "x"], "item 8"),
    ("eval", ["--tasks", "hellaswag"], "item 8"),
]


@pytest.mark.parametrize("cmd,flags,item", REFUSED,
                         ids=[f[0].lstrip("-") for _, f, _ in REFUSED])
def test_unported_flags_exit_naming_their_item(tmp_path, cmd, flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
        main(["--platform", "cpu", cmd, "--model", str(tmp_path)] + flags)


def test_platform_auto_needs_a_gpu(ckpt, tmp_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --platform auto runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["calibrate", "--model", ckpt, "--samples", "1", "--seqlen", "16",
              "--dataset", "synthetic", "--output", str(tmp_path / "c.npz")])


def test_shell_imports_without_jax_or_hf_packages():
    code = (
        "import sys\n"
        "for m in ('jax', 'micromix_tpu', 'ml_dtypes', 'safetensors',"
        " 'transformers', 'tokenizers'):\n"
        "    sys.modules[m] = None\n"
        "import micromix_tpu_torch.cli, micromix_tpu_torch.models.loader\n"
        "import micromix_tpu_torch.models.checkpoint\n"
        "import micromix_tpu_torch.models.safetensors_io\n"
        "import micromix_tpu_torch.serve.api, micromix_tpu_torch.serve.router\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr

