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
* ``serve`` with the prefix cache, alone, with prompt-lookup speculation
  (``--spec-ngram 2``) and with a draft model (``--draft-model``, a dense
  1-layer HF directory cut from the checkpoint) prints the same greedy
  completions as the JAX package's ``serve --prefix-cache``: the JAX
  runner is pointed at its TPU branches there (flash and paged prefill
  kernels in interpret mode), since a cache hit prefills over history.
* ``quantize --hetero``, ``eval --weight-only mxfp8``, ``quantize
  --int8-turbo`` and ``serve --profile DIR`` run end to end: the baked
  checkpoints hold their containers and serve, the weight-only eval
  prints a finite perplexity, the profile is a trace file.
* ``serve --tp 2`` and ``serve --ep 2`` (two gloo ranks, each quantizing
  its shard from the dense checkpoint) print the same completions as the
  library's two ranks on the global tree, sliced.
* ``serve --tp 2 --port`` and ``--ep 2 --port``: rank 0's HTTP server with
  the other rank in lockstep answers completions (one streamed, one
  cancelled mid-stream) equal to batch mode's; ``serve --tp 2 --profile``
  writes one trace a rank.
* ``--platform auto`` raises without a GPU (``eval --tasks``, the last
  flag the port refused, runs since the lm-eval adapter's port:
  ``tests/test_torch_lm_eval.py``).
* The shell's modules import without jax, micromix_tpu, ml_dtypes,
  safetensors and transformers (a subprocess with those blocked).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)
from test_cli import ckpt  # noqa: F401 (fixture: the WordLevel checkpoint)
from test_real_tokenizer_pipeline import (  # noqa: F401 (fixture)
    CORPUS, GOLDEN_QUANT_PPL, bpe_ckpt)
from test_torch_checkpoint import _assert_port_trees_equal

import jax
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


@pytest.fixture(scope="module")
def served(ckpt, tmp_path_factory):  # noqa: F811
    """The port's calibrate and quantize on the WordLevel checkpoint, a
    dense 1-layer draft cut from it (layer 0, the embed, the final norm
    and the head), and the JAX package's ``serve --prefix-cache`` of three
    prompts on two slots: the third shares the first's 20 words, so when
    it is admitted (a slot frees) it hits the first's cached page.
    -> (serve argv, its printed lines, the draft directory)."""
    from safetensors.numpy import load_file, save_file
    d = tmp_path_factory.mktemp("served")
    calib, qdir = str(d / "calib.npz"), str(d / "quantized")
    main(["--platform", "cpu", "calibrate", "--model", ckpt, "--samples",
          "2", "--seqlen", "32", "--dataset", "synthetic", "--output", calib])
    main(["--platform", "cpu", "quantize", "--model", ckpt, "--calibration",
          calib, "--output", qdir])
    draft = d / "draft"
    draft.mkdir()
    tensors = load_file(os.path.join(ckpt, "model.safetensors"))
    save_file({k: v for k, v in tensors.items()
               if not k.startswith("model.layers.1.")},
              str(draft / "model.safetensors"))
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    with open(draft / "config.json", "w") as f:
        json.dump({**cfg, "num_hidden_layers": 1}, f)
    words = [f"w{i}" for i in np.random.default_rng(4).integers(0, 62, 26)]
    prompts = d / "prompts.txt"
    prompts.write_text("\n".join([" ".join(words[:20]), " ".join(words[20:]),
                                   " ".join(words[:20] + ["w7", "w9"])]) + "\n")
    argv = ["serve", "--model", ckpt, "--quantized-ckpt", qdir, "--prompts",
            str(prompts), "--prefix-cache"] + SERVE
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jrunner, "jax", proxy)
        mp.setattr(jrunner, "_can_pair", lambda *a: False)
        jax_main(argv)
    return argv, out.getvalue().strip().splitlines(), str(draft)


SPEC = {"prefix-cache": [], "spec-ngram": ["--spec-ngram", "2"],
        "draft-model": ["--draft-model", None, "--spec-gamma", "3"]}


@pytest.mark.parametrize("mode", list(SPEC))
def test_serve_prefix_cache_and_speculation_print_jax_completions(
        served, capsys, mode):
    """``serve --prefix-cache``, and with it ``--spec-ngram 2`` or
    ``--draft-model DIR``: the completions equal the JAX package's; the
    third prompt hits one 16-token page; the speculative runs print
    ``spec_accept_rate``."""
    argv, ref, draft = served
    flags = [draft if f is None else f for f in SPEC[mode]]
    got = _run(argv + flags, capsys).strip().splitlines()
    assert got[:-1] == ref[:-1]
    assert sum(ln.startswith("--- [") for ln in got) == 3
    gs, rs = json.loads(got[-1]), json.loads(ref[-1])
    assert gs["prefix_hit_tokens"] == rs["prefix_hit_tokens"] == 16
    for key in ("requests", "prefill_tokens", "decode_tokens", "preemptions"):
        assert gs[key] == rs[key], key
    if mode == "prefix-cache":
        assert "spec_accept_rate" not in gs
    else:
        assert 0.0 <= gs["spec_accept_rate"] <= 1.0


@pytest.fixture(scope="module")
def moe_ckpt(ckpt, tmp_path_factory):  # noqa: F811
    """A tiny Mixtral HF directory (4 experts, the WordLevel tokenizer of
    ``ckpt``) and a seeded calibration of one budget for every expert
    (grouping the experts needs one) -> (directory, calibration)."""
    import shutil
    from safetensors.numpy import save_file
    from micromix_tpu.models import ModelConfig as JConfig
    from micromix_tpu.models import random_dense_params
    from micromix_tpu.models.loader import export_dense_params
    from micromix_tpu_torch.calib import save_calibration
    from micromix_tpu_torch.models.surgery import default_calibration
    from micromix_tpu_torch.models.common import ModelConfig
    d = tmp_path_factory.mktemp("mixtral-tiny")
    hf = dict(model_type="mixtral", vocab_size=64, hidden_size=128,
              intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=2,
              rope_theta=10000.0, rms_norm_eps=1e-6, num_local_experts=4,
              num_experts_per_tok=2)
    kw = dict(arch="mixtral", vocab_size=64, hidden_size=128,
              intermediate_size=256, num_layers=2, num_heads=2,
              num_kv_heads=2, head_dim=64, rope_theta=10000.0, rms_eps=1e-6,
              num_experts=4, num_experts_per_tok=2)
    jcfg = JConfig(**kw)
    save_file({k: v.astype(np.float32) for k, v in export_dense_params(
        random_dense_params(jcfg, seed=6), jcfg).items()},
        str(d / "model.safetensors"))
    with open(d / "config.json", "w") as f:
        json.dump(hf, f)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(ckpt, name), d / name)
    calib = str(d / "calib.npz")
    save_calibration(calib, default_calibration(ModelConfig(**kw), seed=6))
    return str(d), calib


def _library_ranks(model, calib, prompts, tok, mode):
    """The library run of ``serve --tp 2`` / ``--ep 2``: the dense
    checkpoint, the calibration's smoothing, the global tree
    (``quantize_model_tp`` / ``quantize_model_ep``) sliced on 2 ranks,
    greedy, the CLI's engine settings -> each rank's completions."""
    import torch_ranks
    from micromix_tpu_torch.calib import load_calibration, smooth_params
    from micromix_tpu_torch.models.loader import config_from_hf, load_dense_params
    from micromix_tpu_torch.parallel import (quantize_model_ep,
                                             quantize_model_tp, spawn)
    with open(os.path.join(model, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    params = load_dense_params(model, cfg, device="cpu")
    calibs, absmax = load_calibration(calib)
    if absmax:
        params = smooth_params(params, cfg, {k: {"absmax": v}
                                             for k, v in absmax.items()})
    engine = dict(max_seqs=2, page_size=16, decode_chunk=2, kv_bits=4)
    specs = [dict(prompt=tok(p)["input_ids"], max_new_tokens=6,
                  eos_id=tok.eos_token_id) for p in prompts]
    run = [dict(engine=engine, specs=specs)]
    if mode == "tp":
        ranks = spawn(torch_ranks.tp_serve, 2, quantize_model_tp(
            params, cfg, calibs, 2), cfg, run, device="cpu")
    else:
        ranks = spawn(torch_ranks.ep_serve, 2, quantize_model_ep(
            params, cfg, calibs), cfg, run, device="cpu", axis="expert")
    return [[tok.decode(t, skip_special_tokens=True) for t in r[0]["tokens"]]
            for r in ranks]


@pytest.mark.parametrize("mode", ["tp", "ep"])
def test_serve_over_ranks_prints_the_library_ranks_completions(
        ckpt, moe_ckpt, tmp_path, capsys, mode):  # noqa: F811
    """``serve --tp 2`` (the Llama, calibrated by the CLI: smoothing
    included) and ``serve --ep 2`` (the Mixtral): two ranks quantize their
    shards from the dense weights; the completions equal the library's
    two ranks on the global tree, sliced; the stats name the ranks and
    gloo."""
    from transformers import AutoTokenizer
    if mode == "tp":
        model, calib = ckpt, str(tmp_path / "calib.npz")
        _run(["calibrate", "--model", ckpt, "--samples", "2", "--seqlen", "32",
              "--dataset", "synthetic", "--output", calib], capsys)
    else:
        model, calib = moe_ckpt
    prompts = ["w1 w2 w3", "w4 w5 w6 w7 w8"]
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("\n".join(prompts) + "\n")
    out = _run(["serve", "--model", model, "--do-quant", "--calibration", calib,
                "--prompts", str(pfile), f"--{mode}", "2"] + SERVE,
               capsys).strip().splitlines()
    stats = json.loads(out[-1])
    assert stats["ranks"] == 2 and stats["backend"] == "gloo"
    assert stats["requests"] == 2 and stats["all_reduces"] > 0
    got = [out[i + 1] if i + 1 < len(out) - 1 and not out[i + 1].startswith("--- [")
           else "" for i, ln in enumerate(out[:-1]) if ln.startswith("--- [")]
    tok = AutoTokenizer.from_pretrained(model, use_fast=True)
    ranks = _library_ranks(model, calib, prompts, tok, mode)
    assert ranks[0] == ranks[1]
    assert got == ranks[0] and all(got), (got, ranks[0])


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, body=None, timeout=120):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _cancelled_stream(port, prompt, n_read=2):
    """A streamed completion whose client goes away after ``n_read``
    events -> the texts it read."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(
        {"prompt": prompt, "max_tokens": 64, "stream": True}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    got = []
    while len(got) < n_read:
        line = resp.fp.readline().decode()
        if line.startswith("data: "):
            got.append(json.loads(line[len("data: "):])["choices"][0]["text"])
    conn.close()
    return got


def _serve_http_ranks(argv, port, prompts):
    """``serve ... --port`` over ranks in a thread: once /health answers,
    the prompts as completions at once (the second one streamed) beside a
    stream whose client goes away, then /metrics; then ``stop_serving``
    -> (texts, metrics, the stats line's dict)."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor
    from micromix_tpu_torch import cli
    buf, err = io.StringIO(), []

    def run():
        try:
            with contextlib.redirect_stdout(buf):
                main(["--platform", "cpu"] + argv)
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            err.append(e)

    th = threading.Thread(target=run)
    th.start()
    try:
        t0 = time.time()
        while True:
            try:
                if _http(port, "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert not err and time.time() - t0 < 300, err
            time.sleep(0.5)

        def one(i):
            if i == 1:
                _, raw = _http(port, "/v1/completions", {
                    "prompt": prompts[i], "max_tokens": 6, "stream": True})
                ev = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
                assert ev[-1] == "[DONE]"
                return "".join(json.loads(e)["choices"][0]["text"]
                               for e in ev[:-1])
            _, body = _http(port, "/v1/completions",
                            {"prompt": prompts[i], "max_tokens": 6})
            return json.loads(body)["choices"][0]["text"]

        with ThreadPoolExecutor(len(prompts) + 1) as ex:
            cut = ex.submit(_cancelled_stream, port, prompts[0])
            texts = list(ex.map(one, range(len(prompts))))
            assert len(cut.result()) == 2
        status, metrics = _http(port, "/metrics")
        assert status == 200
    finally:
        cli.stop_serving()
        th.join(300)
    assert not th.is_alive() and not err, err
    return texts, metrics, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["tp", "ep"])
def test_serve_http_over_ranks_equals_batch_mode(ckpt, moe_ckpt, tmp_path,
                                                 capsys, mode):  # noqa: F811
    """``serve --tp 2 --port`` / ``--ep 2 --port`` on two CPU ranks: rank
    0's HTTP server, the other rank in lockstep.  Completions sent at once
    (one streamed), beside a stream whose client goes away mid-stream (its
    cancel reaches both ranks at the same step boundary: the CLI checks
    the ranks' outputs of every request equal), equal batch mode's
    completions of the same prompts; one slot (``--max-seqs 1``), so each
    request decodes alone in both modes, as in batch mode's schedule."""
    if mode == "tp":
        model, calib = ckpt, str(tmp_path / "calib.npz")
        _run(["calibrate", "--model", ckpt, "--samples", "2", "--seqlen", "32",
              "--dataset", "synthetic", "--output", calib], capsys)
    else:
        model, calib = moe_ckpt
    prompts = ["w1 w2 w3", "w4 w5 w6 w7 w8", "w9 w3 w1", "w2 w2 w5 w7"]
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("\n".join(prompts) + "\n")
    base = ["serve", "--model", model, "--do-quant", "--calibration", calib,
            f"--{mode}", "2", "--max-new-tokens", "6", "--max-seqs", "1",
            "--page-size", "16", "--decode-chunk", "2"]
    out = _run(base + ["--prompts", str(pfile)], capsys).strip().splitlines()
    batch = [out[i + 1] if not out[i + 1].startswith(("--- [", "{")) else ""
             for i, ln in enumerate(out[:-1]) if ln.startswith("--- [")]
    port = _free_port()
    texts, metrics, stats = _serve_http_ranks(base + ["--port", str(port)],
                                              port, prompts)
    assert texts == batch and all(batch), (texts, batch)
    assert "micromix_requests_total 5" in metrics
    assert stats["ranks"] == 2 and stats["backend"] == "gloo"
    assert stats["requests"] == 5 and stats["lockstep_messages"] > 0


def test_serve_profile_over_ranks_writes_a_trace_a_rank(ckpt, tmp_path,
                                                        capsys):  # noqa: F811
    """``serve --tp 2 --profile DIR``: one Chrome trace under DIR/rank0
    and one under DIR/rank1, each with events."""
    calib = str(tmp_path / "calib.npz")
    _run(["calibrate", "--model", ckpt, "--samples", "2", "--seqlen", "32",
          "--dataset", "synthetic", "--output", calib], capsys)
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("w1 w2 w3\nw4 w5 w6 w7\n")
    logdir = tmp_path / "trace"
    stats = _serve_stats(_run(
        ["serve", "--model", ckpt, "--do-quant", "--calibration", calib,
         "--prompts", str(pfile), "--tp", "2", "--profile", str(logdir)]
        + SERVE, capsys))
    assert stats["ranks"] == 2 and stats["decode_tokens"] > 0
    assert sorted(os.listdir(logdir)) == ["rank0", "rank1"]
    for r in ("rank0", "rank1"):
        (name,) = os.listdir(logdir / r)
        with open(logdir / r / name) as f:
            assert json.load(f)["traceEvents"]


def _first_leaf_kinds(qdir):
    """The container kinds of the baked checkpoint's first layer."""
    with open(os.path.join(qdir, "manifest.json")) as f:
        layer = json.load(f)["tree"]["items"]["layers"]["items"][0]["items"]
    return {k: v["kind"] for k, v in layer.items()}


@pytest.mark.parametrize("flag", ["hetero", "weight-only", "int8-turbo",
                                  "profile"])
def test_item8_flags_run_end_to_end(ckpt, tmp_path, capsys, flag):  # noqa: F811
    """Each flag ported in this slice, through the shell on the CPU."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("w1 w2 w3\nw4 w5 w6 w7\n")
    qdir = str(tmp_path / "q")
    if flag == "weight-only":
        out = _run(["eval", "--model", ckpt, "--weight-only", "mxfp8",
                    "--eval-ppl", "synthetic", "--seqlen", "32",
                    "--log-dir", ""], capsys)
        assert np.isfinite(float(out.split("synthetic perplexity:")[1]))
        return
    if flag == "hetero":
        calib = str(tmp_path / "calib.npz")
        _run(["calibrate", "--model", ckpt, "--samples", "2", "--seqlen", "32",
              "--dataset", "synthetic", "--output", calib], capsys)
        _run(["quantize", "--model", ckpt, "--calibration", calib, "--hetero",
              "--output", qdir], capsys)
        kinds = _first_leaf_kinds(qdir)
        assert kinds["attn_site"] == kinds["down_site"] == "FakeQuantSite"
        assert kinds["q"] == "QuantLinear"
    elif flag == "int8-turbo":
        _run(["quantize", "--model", ckpt, "--int8-turbo", "--output", qdir],
             capsys)
        kinds = _first_leaf_kinds(qdir)
        assert kinds["q"] == kinds["down"] == "Int8TurboLinear"
        assert "attn_site" not in kinds
    serve = ["serve", "--model", ckpt, "--prompts", str(prompts)] + SERVE
    if flag == "profile":
        logdir = str(tmp_path / "trace")
        out = _run(serve + ["--weight-only", "mxfp4", "--profile", logdir],
                   capsys)
        (name,) = os.listdir(logdir)
        with open(os.path.join(logdir, name)) as f:
            assert json.load(f)["traceEvents"]
    else:
        out = _run(serve + ["--quantized-ckpt", qdir], capsys)
    stats = _serve_stats(out)
    assert stats["requests"] == 2 and stats["decode_tokens"] > 0


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
        "import micromix_tpu_torch.models.hetero, micromix_tpu_torch.calib\n"
        "import micromix_tpu_torch.utils.profiling\n"
        "import micromix_tpu_torch.models.safetensors_io\n"
        "import micromix_tpu_torch.serve.api, micromix_tpu_torch.serve.router\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr

