"""Command-line entry points: ``python -m micromix_tpu_torch.cli``.

Counterpart of ``micromix_tpu/cli.py`` with the same parser, flag for
flag, and the same printed lines and stats JSON:

  * ``calibrate``  activation statistics -> calibration ``.npz``
  * ``quantize``   smooth + reorder + MX packing, baked once into a
                   checkpoint (the JAX package's format: either package
                   loads the other's)
  * ``eval``       perplexity of a dense, quantized or baked model
  * ``serve``      batch generation through the engine, or with
                   ``--port N`` the OpenAI-style HTTP server

``--platform auto`` runs on the card and raises without one; nothing
falls back to the CPU.  ``--platform cpu`` runs the plain PyTorch
versions.  A flag whose path the port has not ported yet exits with a
message naming its ROADMAP.md item instead of being ignored.  The
tokenizer is ``transformers.AutoTokenizer`` over the checkpoint
directory, imported only where a command needs it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flag -> (is it set?, the ROADMAP.md item that ports its path)
_NOT_PORTED = {
    "tp": (lambda v: v > 1, "item 9 (parallel/ onto torch.distributed)"),
    "ep": (lambda v: v > 1, "item 9 (parallel/ onto torch.distributed)"),
    "hetero": (bool, "item 8 (models/hetero.py)"),
    "weight_only": (bool, "item 8 (WeightOnlyLinear)"),
    "int8_turbo": (bool, "item 8 (Int8TurboLinear)"),
    "draft_model": (bool, "item 7 (speculative decoding)"),
    "spec_ngram": (bool, "item 7 (speculative decoding)"),
    "prefix_cache": (bool, "item 6 (serve/prefix_cache.py)"),
    "profile": (bool, "item 8 (utils/profiling.py)"),
    "tasks": (bool, "item 8 (eval/lm_eval_adapter.py)"),
}


def _refuse_unported(args) -> None:
    for flag, (is_set, item) in _NOT_PORTED.items():
        if is_set(getattr(args, flag, None) or 0):
            raise SystemExit(
                f"--{flag.replace('_', '-')} is not ported to "
                f"micromix_tpu_torch yet: ROADMAP.md {item}")


def _load_model(args):
    from .models.loader import config_from_hf, load_dense_params
    with open(os.path.join(args.model, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    params = load_dense_params(args.model, cfg, device=args.device)
    return cfg, params


def _tokenizer(args):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(args.model, use_fast=True)


def cmd_calibrate(args) -> None:
    from .calib import (collect_calibration, save_calibration,
                        stats_to_calibration)
    from .calib.allocate import average_bits
    from .eval.datasets import get_loaders

    cfg, params = _load_model(args)
    tok = _tokenizer(args)
    t0 = time.time()
    batches, _ = get_loaders(args.dataset, tok, seqlen=args.seqlen,
                             nsamples=args.samples)
    stats = collect_calibration(params, cfg, batches, lamda=args.lamda)
    calibs = stats_to_calibration(stats, cfg)
    print(f"average bits: {average_bits(calibs, cfg):.3f}")
    print(f"calibration time: {time.time() - t0:.1f}s")
    save_calibration(args.output, calibs, stats)
    print(f"saved -> {args.output}")


def _quantize(params, cfg, args):
    """The calibration artifact's smoothing (when it holds absmax and
    ``--smooth``) and quantization, layer by layer: each dense layer is
    dropped once quantized.  Equal to quantize_model(smooth_params(...)),
    as the JAX package computes it."""
    from .calib import load_calibration, smooth_quantize_model
    from .models.surgery import quantize_model

    calibs, absmax = load_calibration(args.calibration)
    kw = dict(weight_fp4_only=not args.symmetric_weights)
    if args.smooth and absmax:
        stats = {k: {"absmax": v} for k, v in absmax.items()}
        return smooth_quantize_model(params, cfg, stats, calibs,
                                     alpha=args.alpha, **kw)
    return quantize_model(params, cfg, calibs, **kw)


def cmd_quantize(args) -> None:
    """Bake smoothing + reorder + MX packing once; persist the result."""
    from .models.checkpoint import save_params

    cfg, params = _load_model(args)
    params = _quantize(params, cfg, args)
    save_params(args.output, params, cfg,
                meta={"source": args.model,
                      "calibration": args.calibration,
                      "symmetric_weights": args.symmetric_weights})
    print(f"quantized checkpoint -> {args.output}")


def _load_for_run(args):
    """-> (cfg, params): a baked checkpoint, or the HF directory's dense
    weights, quantized when ``--do-quant``."""
    if args.quantized_ckpt:
        from .models.checkpoint import load_params
        params, cfg, _ = load_params(args.quantized_ckpt, device=args.device)
        assert cfg is not None, "checkpoint has no ModelConfig"
        return cfg, params
    cfg, params = _load_model(args)
    if args.do_quant:
        params = _quantize(params, cfg, args)
    return cfg, params


def cmd_eval(args) -> None:
    from .eval.datasets import get_loaders
    from .eval.ppl import eval_ppl

    cfg, params = _load_for_run(args)
    tok = _tokenizer(args)

    results = {}
    if args.eval_ppl:
        for name in args.eval_ppl.split(","):
            _, stream = get_loaders(name, tok)
            ppl = eval_ppl(params, cfg, stream, seqlen=args.seqlen,
                           kv_quant_bits=args.kv_bits,
                           progress=lambda i, n: print(
                               f"\r{name} {i}/{n}", end="", flush=True))
            print()
            results[f"ppl/{name}"] = ppl
            print(f"{name} perplexity: {ppl:.4f}")

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        with open(os.path.join(args.log_dir, f"log_{stamp}.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)


def cmd_serve(args) -> None:
    """Batch-generate with the continuous-batching engine: one prompt per
    line, completions and stats printed; or the HTTP API with --port."""
    import numpy as np
    from .serve import Engine, Request
    from .serve.sampling import SamplingParams

    if not args.port and not args.prompts:
        raise SystemExit("serve: need --prompts FILE (batch mode) or "
                         "--port N (HTTP API mode)")
    cfg, params = _load_for_run(args)
    tok = _tokenizer(args)
    prompts = []
    if args.prompts:
        with open(args.prompts) as f:
            prompts = [ln.rstrip("\n") for ln in f if ln.strip()]
    eng = Engine(params, cfg, max_seqs=args.max_seqs,
                 page_size=args.page_size, kv_bits=args.kv_bits or 4,
                 decode_chunk=args.decode_chunk, device=args.device)
    if args.port:
        from .serve.api import ApiServer
        chat_tpl = None
        if getattr(tok, "chat_template", None):
            chat_tpl = lambda msgs: tok.apply_chat_template(  # noqa: E731
                msgs, tokenize=False, add_generation_prompt=True)
        srv = ApiServer(
            eng, lambda s: tok(s)["input_ids"],
            lambda ids: tok.decode(ids, skip_special_tokens=True),
            model_name=os.path.basename(args.model.rstrip("/")),
            eos_id=tok.eos_token_id, chat_template=chat_tpl,
            port=args.port)
        print(json.dumps({"serving": f"http://127.0.0.1:{srv.port}",
                          "endpoints": ["/v1/completions",
                                        "/v1/chat/completions",
                                        "/v1/models", "/health",
                                        "/metrics"]}),
              flush=True)
        srv.serve_forever()
        return
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              min_p=args.min_p)
    reqs = [
        Request(req_id=i, prompt=tok(p)["input_ids"],
                max_new_tokens=args.max_new_tokens, sampling=sampling,
                eos_id=tok.eos_token_id)
        for i, p in enumerate(prompts)
    ]
    t0 = time.time()
    eng.run(reqs)
    dt = time.time() - t0
    for r in reqs:
        print(f"--- [{r.req_id}] ---")
        print(tok.decode(r.output, skip_special_tokens=True))
    ttfts = [eng.ttft[r.req_id] for r in reqs if r.req_id in eng.ttft]
    stats = {
        "requests": len(reqs),
        "prefill_tokens": eng.prefill_tokens,
        "decode_tokens": eng.decode_tokens,
        "preemptions": eng.preemptions,
        "wall_s": round(dt, 3),
        "decode_tokens_per_s": round(eng.decode_tokens / dt, 2),
        "mean_ttft_ms": round(1e3 * float(np.mean(ttfts)), 2),
        # host wall seconds per engine phase ("mixed" = piggybacked
        # prefill + decode calls)
        "phase_s": {k: round(v, 3) for k, v in eng.phase_s.items() if v},
    }
    if eng.spec_proposed:
        stats["spec_accept_rate"] = round(
            eng.spec_accepted / eng.spec_proposed, 3)
    if eng.prefix_hit_tokens:
        stats["prefix_hit_tokens"] = eng.prefix_hit_tokens
    print(json.dumps(stats))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="micromix_tpu_torch")
    ap.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                    help="auto = the GPU (raises without one); cpu = the "
                         "plain PyTorch versions on the CPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("calibrate", help="reorder-index calibration")
    c.add_argument("--model", required=True, help="local HF checkpoint dir")
    c.add_argument("--samples", type=int, default=32)
    c.add_argument("--seqlen", type=int, default=2048)
    c.add_argument("--lamda", type=float, default=1.0)
    c.add_argument("--dataset", default="wikitext2")
    c.add_argument("--output", default="saved/calibration.npz")
    c.set_defaults(fn=cmd_calibrate)

    q = sub.add_parser("quantize",
                       help="bake + persist a quantized checkpoint")
    q.add_argument("--model", required=True, help="local HF checkpoint dir")
    q.add_argument("--calibration", default="saved/calibration.npz")
    q.add_argument("--smooth", action="store_true", default=True)
    q.add_argument("--no-smooth", dest="smooth", action="store_false")
    q.add_argument("--alpha", type=float, default=0.5)
    q.add_argument("--symmetric-weights", action="store_true")
    q.add_argument("--hetero", action="store_true",
                   help="budgets-as-data hetero representation (not ported)")
    q.add_argument("--int8-turbo", action="store_true",
                   help="W8A8 int8 speed mode (not ported)")
    q.add_argument("--weight-only", choices=("mxfp4", "mxfp6", "mxfp8"),
                   default=None, help="weight-only MX mode (not ported)")
    q.add_argument("--output", default="saved/quantized")
    q.set_defaults(fn=cmd_quantize)

    e = sub.add_parser("eval", help="perplexity / lm-eval tasks")
    e.add_argument("--model", required=True)
    e.add_argument("--quantized-ckpt", default=None,
                   help="load a baked quantized checkpoint (skips surgery)")
    e.add_argument("--do-quant", action="store_true")
    e.add_argument("--weight-only", choices=("mxfp4", "mxfp6", "mxfp8"),
                   default=None, help="weight-only MX mode (not ported)")
    e.add_argument("--calibration", default="saved/calibration.npz")
    e.add_argument("--smooth", action="store_true", default=True)
    e.add_argument("--no-smooth", dest="smooth", action="store_false")
    e.add_argument("--alpha", type=float, default=0.5)
    e.add_argument("--symmetric-weights", action="store_true",
                   help="W4/6/8 per segment instead of all-MXFP4 weights")
    e.add_argument("--hetero", action="store_true",
                   help="budgets-as-data hetero representation (not ported)")
    e.add_argument("--eval-ppl", default="",
                   help="comma list: synthetic, file:<path> (wikitext2, "
                        "ptb, c4 need a download)")
    e.add_argument("--tasks", default="", help="lm-eval tasks (not ported)")
    e.add_argument("--num-fewshot", type=int, default=0)
    e.add_argument("--limit", type=int, default=None)
    e.add_argument("--seqlen", type=int, default=2048)
    e.add_argument("--kv-bits", type=int, default=None,
                   help="int-group KV fake quant bits (e.g. 4)")
    e.add_argument("--log-dir", default="results")
    e.set_defaults(fn=cmd_eval)

    s = sub.add_parser("serve", help="batch generation (continuous batching)")
    s.add_argument("--model", required=True)
    s.add_argument("--quantized-ckpt", default=None)
    s.add_argument("--do-quant", action="store_true")
    s.add_argument("--weight-only", choices=("mxfp4", "mxfp6", "mxfp8"),
                   default=None, help="weight-only MX mode (not ported)")
    s.add_argument("--calibration", default="saved/calibration.npz")
    s.add_argument("--smooth", action="store_true", default=True)
    s.add_argument("--no-smooth", dest="smooth", action="store_false")
    s.add_argument("--alpha", type=float, default=0.5)
    s.add_argument("--symmetric-weights", action="store_true")
    s.add_argument("--hetero", action="store_true",
                   help="budgets-as-data hetero representation (not ported)")
    s.add_argument("--prompts", default=None,
                   help="file, one prompt/line (batch mode)")
    s.add_argument("--port", type=int, default=0, metavar="N",
                   help="run an OpenAI-style completions HTTP server "
                        "instead of batch mode (/v1/completions, "
                        "/v1/models, /health, /metrics)")
    s.add_argument("--max-new-tokens", type=int, default=128)
    s.add_argument("--max-seqs", type=int, default=8)
    s.add_argument("--page-size", type=int, default=128)
    s.add_argument("--kv-bits", type=int, default=4)
    s.add_argument("--decode-chunk", type=int, default=8)
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (not ported)")
    s.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ways (not ported)")
    s.add_argument("--prefix-cache", action="store_true",
                   help="share KV pages across common prompt prefixes "
                        "(not ported)")
    s.add_argument("--draft-model", default=None, metavar="DIR",
                   help="draft model for speculative decoding (not ported)")
    s.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    s.add_argument("--spec-ngram", type=int, default=0, metavar="N",
                   help="prompt-lookup speculation (not ported)")
    s.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a profiler trace of the run (not ported)")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--top-p", type=float, default=1.0)
    s.add_argument("--min-p", type=float, default=0.0,
                   help="keep tokens with prob >= min_p * max prob")
    s.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    _refuse_unported(args)
    args.device = "cpu" if args.platform == "cpu" else None
    args.fn(args)


if __name__ == "__main__":
    main()
