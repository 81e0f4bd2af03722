"""Command-line entry points: ``python -m micromix_tpu_torch.cli``.

Counterpart of ``micromix_tpu/cli.py`` with the same parser, flag for
flag, and the same printed lines and stats JSON:

  * ``calibrate``  activation statistics -> calibration ``.npz``
  * ``quantize``   smooth + reorder + MX packing (segmented, or the
                   hetero form with ``--hetero``), weight-only MX
                   (``--weight-only``) or W8A8 int8 (``--int8-turbo``),
                   baked once into a checkpoint (the JAX package's
                   format: either package loads the other's)
  * ``eval``       perplexity of a dense, quantized or baked model, and
                   lm-eval tasks (``--tasks``, through
                   ``eval/lm_eval_adapter.py``; needs ``lm_eval``)
  * ``serve``      batch generation through the engine (a profiler trace
                   of the run with ``--profile DIR``), or with
                   ``--port N`` the OpenAI-style HTTP server; with
                   ``--tp N`` / ``--ep N`` over N ranks
                   (``parallel.spawn``: N processes, each quantizing its
                   shard from the dense checkpoint and serving it with its
                   own engine; this process tokenizes, checks that every
                   rank emitted the same tokens, and prints rank 0's
                   completions and stats).  Over ranks, ``--port`` serves
                   rank 0's ApiServer with the other ranks in lockstep
                   (``parallel/api_ranks.py``) until SIGINT / SIGTERM (or
                   ``stop_serving()`` from another thread), then prints
                   the stats line; ``--profile DIR`` writes one trace a
                   rank, ``DIR/rank{r}/``

``--platform auto`` runs on the card and raises without one; nothing
falls back to the CPU.  ``--platform cpu`` runs the plain PyTorch
versions.  The
tokenizer is ``transformers.AutoTokenizer`` over the checkpoint
directory, imported only where a command needs it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# the stop events of the servers over ranks that this process runs
_SERVING = []


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
    ``--smooth``) and quantization (the hetero form with ``--hetero``),
    layer by layer: each dense layer is dropped once quantized.  Equal to
    quantize_model(smooth_params(...)) or quantize_model_hetero(...), as
    the JAX package computes it."""
    from .calib import load_calibration, smooth_quantize_model
    from .models.hetero import quantize_model_hetero
    from .models.surgery import quantize_model

    calibs, absmax = load_calibration(args.calibration)
    # on the CPU the native host quantizer, faster there than torch's
    kw = {} if args.hetero else dict(
        weight_fp4_only=not args.symmetric_weights,
        host=args.device == "cpu")
    if args.smooth and absmax:
        stats = {k: {"absmax": v} for k, v in absmax.items()}
        return smooth_quantize_model(params, cfg, stats, calibs,
                                     alpha=args.alpha, hetero=args.hetero,
                                     **kw)
    if args.hetero:
        return quantize_model_hetero(params, cfg, calibs)
    return quantize_model(params, cfg, calibs, **kw)


def _weight_only(params, cfg, args):
    from .models.surgery import quantize_model_weight_only
    return quantize_model_weight_only(params, cfg, args.weight_only)


def cmd_quantize(args) -> None:
    """Bake smoothing + reorder + MX packing once; persist the result."""
    from .models.checkpoint import save_params

    cfg, params = _load_model(args)
    if args.int8_turbo:
        from .models.surgery import quantize_model_int8_turbo
        params = quantize_model_int8_turbo(params, cfg)
    elif args.weight_only:
        params = _weight_only(params, cfg, args)
    else:
        params = _quantize(params, cfg, args)
    save_params(args.output, params, cfg,
                meta={"source": args.model,
                      "calibration": args.calibration,
                      "symmetric_weights": args.symmetric_weights})
    print(f"quantized checkpoint -> {args.output}")


def _load_for_run(args):
    """-> (cfg, params): a baked checkpoint, or the HF directory's dense
    weights, weight-only quantized with ``--weight-only``, else quantized
    when ``--do-quant``."""
    if args.quantized_ckpt:
        from .models.checkpoint import load_params
        params, cfg, _ = load_params(args.quantized_ckpt, device=args.device)
        assert cfg is not None, "checkpoint has no ModelConfig"
        return cfg, params
    cfg, params = _load_model(args)
    if args.weight_only:
        params = _weight_only(params, cfg, args)
    elif args.do_quant:
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

    if args.tasks:
        from .eval.lm_eval_adapter import Scorer, run_lm_eval
        scorer = Scorer(params, cfg, max_len=args.seqlen,
                        kv_quant_bits=args.kv_bits)
        out = run_lm_eval(scorer, tok, args.tasks.split(","),
                          num_fewshot=args.num_fewshot, limit=args.limit)
        results["lm_eval"] = out["results"]
        print(json.dumps(out["results"], indent=2, default=str))

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        with open(os.path.join(args.log_dir, f"log_{stamp}.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)


def _check_ranks(args) -> int:
    """The --tp / --ep checks the JAX package makes before loading
    anything; -> the rank count (1 without either)."""
    if args.tp > 1 and args.ep > 1:
        raise SystemExit("--tp and --ep are mutually exclusive (TP serves "
                         "dense models; EP serves Mixtral experts)")
    n = max(args.tp, args.ep)
    if n <= 1:
        return 1
    if args.quantized_ckpt or args.weight_only:
        # the ranks quantize their shards from the dense weights
        raise SystemExit("--tp requires --do-quant from a dense model "
                         "(not --quantized-ckpt or --weight-only)")
    if not args.prompts and not args.port:
        raise SystemExit("serve --tp / --ep: need --prompts FILE (batch "
                         "mode) or --port N (HTTP API mode)")
    if args.ep > 1:
        from .models.loader import config_from_hf
        with open(os.path.join(args.model, "config.json")) as f:
            if not config_from_hf(json.load(f)).is_moe:
                raise SystemExit("--ep requires a Mixtral (MoE) checkpoint")
    return n


def _serve_rank(group, args, prompts, eos_id, tok=None, stop=None):
    """One rank of ``serve --tp`` / ``--ep``: the dense checkpoint, the
    calibration's smoothing, the rank's shard quantized, its engine over
    the prompt token ids -> (outputs, stats); with ``--port``, rank 0's
    HTTP server over ``tok`` until ``stop`` is set, the others following
    it -> ({req_id: outputs}, stats)."""
    from .calib import load_calibration, smooth_params
    from .parallel import (make_ep_engine, make_tp_engine, quantize_model_ep,
                           quantize_model_tp, quantize_model_tp_hetero)
    from .serve import Request
    from .serve.sampling import SamplingParams

    args.device = str(group.device)
    cfg, params = _load_model(args)
    calibs, absmax = load_calibration(args.calibration)
    if args.smooth and absmax:
        stats = {k: {"absmax": v} for k, v in absmax.items()}
        params = smooth_params(params, cfg, stats, alpha=args.alpha)
    if args.tp > 1:
        if args.hetero:
            tparams = quantize_model_tp_hetero(params, cfg, calibs, args.tp,
                                               group=group)
        else:
            tparams = quantize_model_tp(
                params, cfg, calibs, args.tp,
                weight_fp4_only=not args.symmetric_weights, group=group)
        del params
        eng = make_tp_engine(tparams, cfg, group,
                             **_engine_kw(args, group.device))
    else:
        qm = quantize_model_ep(params, cfg, calibs)
        del params
        eng = make_ep_engine(qm, cfg, group, **_engine_kw(args, group.device))
    group.reset_counts()
    with _rank_trace(args, group.rank):
        if args.port:
            return _serve_http_rank(group, eng, args, tok, stop)
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  min_p=args.min_p)
        reqs = [Request(req_id=i, prompt=ids,
                        max_new_tokens=args.max_new_tokens,
                        sampling=sampling, eos_id=eos_id)
                for i, ids in enumerate(prompts)]
        t0 = time.time()
        eng.run(reqs)
        dt = time.time() - t0
    stats = _serve_stats(eng, reqs, dt)
    stats.update(ranks=group.world, backend=group.backend,
                 all_reduces=group.reduces)
    return [r.output for r in reqs], stats


def _rank_trace(args, rank: int):
    """``--profile DIR``: the rank's trace under ``DIR/rank{rank}``."""
    import contextlib
    if not args.profile:
        return contextlib.nullcontext()
    from .utils.profiling import trace
    return trace(os.path.join(args.profile, f"rank{rank}"))


def _api_server(eng, tok, args):
    from .serve.api import ApiServer
    chat_tpl = None
    if getattr(tok, "chat_template", None):
        chat_tpl = lambda msgs: tok.apply_chat_template(  # noqa: E731
            msgs, tokenize=False, add_generation_prompt=True)
    return ApiServer(
        eng, lambda s: tok(s)["input_ids"],
        lambda ids: tok.decode(ids, skip_special_tokens=True),
        model_name=os.path.basename(args.model.rstrip("/")),
        eos_id=tok.eos_token_id, chat_template=chat_tpl, port=args.port)


def _print_serving(port: int) -> None:
    print(json.dumps({"serving": f"http://127.0.0.1:{port}",
                      "endpoints": ["/v1/completions", "/v1/chat/completions",
                                    "/v1/models", "/health", "/metrics"]}),
          flush=True)


def _serve_http_rank(group, eng, args, tok, stop):
    """Rank 0: the ApiServer over the ranks' one replica, until ``stop``;
    the others: follow its boundaries.  -> (every request's outputs by
    id, stats)."""
    import signal
    from .parallel.api_ranks import serve_http
    from .parallel.replicas import ReplicaRouter
    # the parent stops the server: Ctrl-C reaches the ranks too
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    router = ReplicaRouter(group, lambda g, r: eng)
    st = serve_http(router, lambda rt: _api_server(rt, tok, args), stop,
                    on_start=lambda srv: _print_serving(srv.port))
    stats = {"requests": st["requests"], "prefill_tokens": eng.prefill_tokens,
             "decode_tokens": eng.decode_tokens, "wall_s": st["wall_s"],
             "lockstep_messages": st["messages"], "ranks": group.world,
             "backend": group.backend, "all_reduces": group.reduces}
    return router.outputs(), stats


def stop_serving() -> None:
    """Stop the ``serve --tp / --ep --port`` servers this process runs
    (from another thread; the signal handlers do it in the main one)."""
    for ev in list(_SERVING):
        ev.set()


def _engine_kw(args, device) -> dict:
    """The engine's keywords from the serve flags (speculation included)."""
    spec_kw = {}
    if args.draft_model:
        # the draft stays dense bf16: it is small, and the target model
        # dominates both memory and operations
        from .models.loader import config_from_hf, load_dense_params
        with open(os.path.join(args.draft_model, "config.json")) as f:
            dcfg = config_from_hf(json.load(f))
        spec_kw = dict(draft_params=load_dense_params(args.draft_model, dcfg,
                                                      device=device),
                       draft_cfg=dcfg, spec_gamma=args.spec_gamma)
    elif args.spec_ngram:
        spec_kw = dict(spec_ngram=args.spec_ngram, spec_gamma=args.spec_gamma)
    return dict(max_seqs=args.max_seqs, page_size=args.page_size,
                kv_bits=args.kv_bits or 4, decode_chunk=args.decode_chunk,
                prefix_cache=args.prefix_cache, device=device, **spec_kw)


def _serve_stats(eng, reqs, dt: float) -> dict:
    import numpy as np
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
    return stats


def _serve_ranks(args, n: int) -> None:
    """``serve --tp N`` / ``--ep N``: N ranks over the prompts file, or
    with ``--port`` rank 0's HTTP server until stopped."""
    from .parallel import spawn

    tok = _tokenizer(args)
    kw = dict(device=args.device or "cuda",
              axis="model" if args.tp > 1 else "expert")
    if args.port:
        outs = _serve_ranks_http(spawn, args, n, tok, kw)
    else:
        with open(args.prompts) as f:
            prompts = [tok(ln.rstrip("\n"))["input_ids"] for ln in f
                       if ln.strip()]
        outs = spawn(_serve_rank, n, args, prompts, tok.eos_token_id, **kw)
    for r, (toks, _) in enumerate(outs[1:], start=1):
        if toks != outs[0][0]:
            raise SystemExit(f"rank {r} emitted other tokens than rank 0")
    toks, stats = outs[0]
    if not args.port:
        for i, ids in enumerate(toks):
            print(f"--- [{i}] ---")
            print(tok.decode(ids, skip_special_tokens=True))
    print(json.dumps(stats))


def _serve_ranks_http(spawn, args, n: int, tok, kw):
    """The ranks' HTTP server until SIGINT / SIGTERM or ``stop_serving``:
    each stops rank 0's server, which stops the others."""
    import signal
    import threading
    import torch.multiprocessing as mp
    stop = mp.get_context("spawn").Event()
    _SERVING.append(stop)
    saved = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            saved[sig] = signal.signal(sig, lambda *_: stop.set())
    try:
        return spawn(_serve_rank, n, args, None, tok.eos_token_id, tok, stop,
                     **kw)
    finally:
        _SERVING.remove(stop)
        for sig, h in saved.items():
            signal.signal(sig, h)


def cmd_serve(args) -> None:
    """Batch-generate with the continuous-batching engine: one prompt per
    line, completions and stats printed; or the HTTP API with --port."""
    from .serve import Engine, Request
    from .serve.sampling import SamplingParams

    n_ranks = _check_ranks(args)
    if n_ranks > 1:
        _serve_ranks(args, n_ranks)
        return
    if not args.port and not args.prompts:
        raise SystemExit("serve: need --prompts FILE (batch mode) or "
                         "--port N (HTTP API mode)")
    cfg, params = _load_for_run(args)
    tok = _tokenizer(args)
    prompts = []
    if args.prompts:
        with open(args.prompts) as f:
            prompts = [ln.rstrip("\n") for ln in f if ln.strip()]
    eng = Engine(params, cfg, **_engine_kw(args, args.device))
    if args.port:
        srv = _api_server(eng, tok, args)
        _print_serving(srv.port)
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
    if args.profile:
        from .utils.profiling import trace
        with trace(args.profile):
            eng.run(reqs)
    else:
        eng.run(reqs)
    dt = time.time() - t0
    for r in reqs:
        print(f"--- [{r.req_id}] ---")
        print(tok.decode(r.output, skip_special_tokens=True))
    print(json.dumps(_serve_stats(eng, reqs, dt)))


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
                   help="budgets-as-data hetero representation")
    q.add_argument("--int8-turbo", action="store_true",
                   help="W8A8 int8 (out-of-spec speed mode, not MicroMix "
                        "numerics)")
    q.add_argument("--weight-only", choices=("mxfp4", "mxfp6", "mxfp8"),
                   default=None)
    q.add_argument("--output", default="saved/quantized")
    q.set_defaults(fn=cmd_quantize)

    e = sub.add_parser("eval", help="perplexity / lm-eval tasks")
    e.add_argument("--model", required=True)
    e.add_argument("--quantized-ckpt", default=None,
                   help="load a baked quantized checkpoint (skips surgery)")
    e.add_argument("--do-quant", action="store_true")
    e.add_argument("--weight-only", choices=("mxfp4", "mxfp6", "mxfp8"),
                   default=None,
                   help="weight-only MX quantization (no calibration)")
    e.add_argument("--calibration", default="saved/calibration.npz")
    e.add_argument("--smooth", action="store_true", default=True)
    e.add_argument("--no-smooth", dest="smooth", action="store_false")
    e.add_argument("--alpha", type=float, default=0.5)
    e.add_argument("--symmetric-weights", action="store_true",
                   help="W4/6/8 per segment instead of all-MXFP4 weights")
    e.add_argument("--hetero", action="store_true",
                   help="budgets-as-data hetero representation")
    e.add_argument("--eval-ppl", default="",
                   help="comma list: wikitext2, ptb, c4 (from the local "
                        "datasets cache), synthetic, file:<path>")
    e.add_argument("--tasks", default="", help="lm-eval task list")
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
                   default=None, help="weight-only MX mode (bf16 acts)")
    s.add_argument("--calibration", default="saved/calibration.npz")
    s.add_argument("--smooth", action="store_true", default=True)
    s.add_argument("--no-smooth", dest="smooth", action="store_false")
    s.add_argument("--alpha", type=float, default=0.5)
    s.add_argument("--symmetric-weights", action="store_true")
    s.add_argument("--hetero", action="store_true",
                   help="budgets-as-data hetero representation")
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
                   help="tensor-parallel ranks (dense models)")
    s.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ranks (Mixtral)")
    s.add_argument("--prefix-cache", action="store_true",
                   help="share KV pages across common prompt prefixes")
    s.add_argument("--draft-model", default=None, metavar="DIR",
                   help="dense HF draft model for speculative decoding")
    s.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    s.add_argument("--spec-ngram", type=int, default=0, metavar="N",
                   help="prompt-lookup speculation: propose the tokens that "
                        "followed the last N-token match in the request's "
                        "own history (no draft model)")
    s.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace of the run there")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--top-p", type=float, default=1.0)
    s.add_argument("--min-p", type=float, default=0.0,
                   help="keep tokens with prob >= min_p * max prob")
    s.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    args.device = "cpu" if args.platform == "cpu" else None
    args.fn(args)


if __name__ == "__main__":
    main()
