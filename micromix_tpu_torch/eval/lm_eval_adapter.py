"""lm-evaluation-harness adapter (zero / few-shot tasks).

Counterpart of ``micromix_tpu/eval/lm_eval_adapter.py``.  ``Scorer`` holds
the scoring primitives, which need no harness: a continuation's
log-likelihood and greedy-match flag, a rolling log-likelihood over
windows, and greedy generation, each over the whole-window ``forward``
(no KV cache, as in the JAX package) on the params' device.
``make_lm_eval_model`` registers them with lm-eval 0.4's ``LM`` when that
package is importable; ``run_lm_eval`` calls its ``simple_evaluate``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models.common import ModelConfig
from ..models.transformer import forward


class Scorer:
    """Log-likelihood scoring and greedy generation on a (possibly
    quantized) model; sequences are cut to their last ``max_len`` tokens."""

    def __init__(self, params, cfg: ModelConfig, max_len: int = 2048,
                 kv_quant_bits: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.kv_quant_bits = kv_quant_bits
        self.device = params["embed"].device

    def _logits(self, toks: List[int]) -> torch.Tensor:
        """toks -> (len(toks), vocab) f32 logits on the params' device."""
        t = torch.tensor([toks], dtype=torch.long, device=self.device)
        with torch.inference_mode():
            return forward(self.params, self.cfg, t,
                           kv_quant_bits=self.kv_quant_bits)[0]

    def loglikelihood_tokens(self, context: List[int],
                             continuation: List[int]) -> Tuple[float, bool]:
        """-> (summed log p of the continuation's tokens, whether each is
        the greedy argmax)."""
        toks = (context + continuation)[-self.max_len:]
        n_cont = len(continuation)
        # positions predicting the continuation
        start = len(toks) - n_cont - 1
        logp = torch.log_softmax(
            self._logits(toks)[start:start + n_cont].to(torch.float32), dim=-1)
        tgt = torch.tensor(toks[start + 1:], dtype=torch.long,
                           device=logp.device)
        picked = logp.gather(-1, tgt[:, None])[:, 0].double().cpu()
        greedy = bool(torch.equal(logp.argmax(-1), tgt))
        ll = 0.0
        for x in picked.tolist():   # summed in f64, one term at a time
            ll += x
        return ll, greedy

    def rolling_loglikelihood(self, tokens: List[int]) -> float:
        """Summed next-token log p over windows of ``max_len`` tokens that
        step by ``max_len - 1`` (each window's first token is the last
        one's target)."""
        total = 0.0
        for i in range(0, max(1, len(tokens) - 1), self.max_len - 1):
            window = tokens[i:i + self.max_len]
            if len(window) < 2:
                break
            logp = torch.log_softmax(
                self._logits(window)[:-1].to(torch.float32), dim=-1)
            tgt = torch.tensor(window[1:], dtype=torch.long,
                               device=logp.device)
            total += float(logp.gather(-1, tgt[:, None]).sum())
        return total

    def greedy_generate(self, context: List[int], max_new: int,
                        stop_ids: Optional[List[int]] = None) -> List[int]:
        """Up to ``max_new`` argmax tokens, each from a whole forward of
        the last ``max_len`` tokens; stops after a token of ``stop_ids``."""
        toks = list(context)
        for _ in range(max_new):
            nxt = int(torch.argmax(self._logits(toks[-self.max_len:])[-1]))
            toks.append(nxt)
            if stop_ids and nxt in stop_ids:
                break
        return toks[len(context):]


def make_lm_eval_model(scorer: Scorer, tokenizer):
    """An lm-eval ``LM`` instance over ``scorer``; raises ImportError
    without ``lm_eval``."""
    import lm_eval.api.model as lm_model

    class MicroMixLM(lm_model.LM):
        def __init__(self):
            super().__init__()
            self.tok = tokenizer

        def loglikelihood(self, requests):
            out = []
            for req in requests:
                ctx, cont = req.args
                ctx_ids = self.tok.encode(ctx) if ctx else [
                    self.tok.bos_token_id or 0]
                cont_ids = self.tok.encode(cont, add_special_tokens=False)
                out.append(scorer.loglikelihood_tokens(ctx_ids, cont_ids))
            return out

        def loglikelihood_rolling(self, requests):
            return [
                scorer.rolling_loglikelihood(self.tok.encode(req.args[0]))
                for req in requests
            ]

        def generate_until(self, requests):
            outs = []
            for req in requests:
                ctx, kw = req.args
                ctx_ids = self.tok.encode(ctx)
                max_new = kw.get("max_gen_toks", 128)
                ids = scorer.greedy_generate(ctx_ids, max_new)
                outs.append(self.tok.decode(ids))
            return outs

    return MicroMixLM()


def run_lm_eval(scorer: Scorer, tokenizer, tasks: List[str],
                num_fewshot: int = 0, limit: Optional[int] = None):
    """lm-eval's ``simple_evaluate`` over ``scorer``."""
    import lm_eval
    lm = make_lm_eval_model(scorer, tokenizer)
    return lm_eval.simple_evaluate(model=lm, tasks=tasks,
                                   num_fewshot=num_fewshot, limit=limit)
