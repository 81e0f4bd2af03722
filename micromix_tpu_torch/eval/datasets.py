"""Dataset loaders for calibration and evaluation.

Counterpart of ``micromix_tpu/eval/datasets.py``: ``synthetic_tokens`` (a
numpy copy: the same stream for the same seed), a local text file
(``file:<path>``) and the hub corpora wikitext2, ptb and c4 with the JAX
package's dataset names, splits and document count.  The hub loaders go
through ``datasets.load_dataset``, imported when a loader runs; they read
only what the local ``datasets`` cache already holds where the machine
has no network, and a missing package or cache raises the JAX package's
``RuntimeError`` ("unavailable (offline?)").
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def synthetic_tokens(vocab_size: int, length: int, seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-ish synthetic token stream (offline testing)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab_size, size=length, p=probs).astype(np.int32)


def _tokenize_join(texts: List[str], tokenizer) -> np.ndarray:
    enc = tokenizer("\n\n".join(texts), return_tensors="np")
    return np.asarray(enc["input_ids"]).reshape(-1)


def get_wikitext2(tokenizer, split: str = "test") -> np.ndarray:
    from datasets import load_dataset
    ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    return _tokenize_join(ds["text"], tokenizer)


def get_ptb(tokenizer, split: str = "test") -> np.ndarray:
    from datasets import load_dataset
    ds = load_dataset("ptb_text_only", "penn_treebank", split=split)
    return _tokenize_join(ds["sentence"], tokenizer)


def get_c4(tokenizer, split: str = "validation",
           n_docs: int = 1100) -> np.ndarray:
    """The first ``n_docs`` documents of c4's first English shard,
    streamed."""
    from datasets import load_dataset
    ds = load_dataset(
        "allenai/c4", data_files={split: "en/c4-train.00000-of-01024.json.gz"},
        split=split, streaming=True)
    texts = []
    for i, row in enumerate(ds):
        if i >= n_docs:
            break
        texts.append(row["text"])
    return _tokenize_join(texts, tokenizer)


def get_textfile(tokenizer, path: str, split: str = "test") -> np.ndarray:
    """A local raw-text corpus: lines split 90/10 into train / test
    (order kept), so calibration windows and the evaluation stream never
    overlap."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    cut = max(1, int(len(lines) * 0.9))
    texts = lines[:cut] if split == "train" else lines[cut:]
    if not texts:
        raise ValueError(
            f"file:{path} has {len(lines)} line(s) — too few for a "
            f"non-empty {split!r} split (90/10 line split needs >= 2)")
    return _tokenize_join(texts, tokenizer)


_LOADERS = {"wikitext2": get_wikitext2, "ptb": get_ptb, "c4": get_c4}


def get_loaders(name: str, tokenizer, *, split: str = "test",
                seqlen: int = 2048, nsamples: Optional[int] = None,
                seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    """-> (calibration windows, test stream): ``nsamples`` windows of
    (1, seqlen) from the train split and the flat test ids."""
    if name == "synthetic":
        vocab = int(getattr(tokenizer, "vocab_size", None) or len(tokenizer))
        test = synthetic_tokens(vocab, max(4 * seqlen, 4096), seed=seed + 1)
        train = synthetic_tokens(vocab, max(8 * seqlen, 8192), seed=seed)
        rng = np.random.default_rng(seed)
        calib_batches = [
            train[i:i + seqlen][None, :]
            for i in rng.integers(0, len(train) - seqlen - 1,
                                  size=nsamples or 0)
        ]
        return calib_batches, test
    if name.startswith("file:"):
        path = name[len("file:"):]
        loader = lambda tok, split: get_textfile(tok, path, split=split)
    elif name in _LOADERS:
        loader = _LOADERS[name]
    else:
        raise ValueError(f"unknown dataset {name!r}; one of "
                         f"{list(_LOADERS) + ['synthetic', 'file:<path>']}")
    try:
        test = loader(tokenizer, split=split)
        calib_batches: List[np.ndarray] = []
        if nsamples:
            train = loader(tokenizer, split="train")
            rng = np.random.default_rng(seed)
            for _ in range(nsamples):
                i = rng.integers(0, len(train) - seqlen - 1)
                calib_batches.append(train[i:i + seqlen][None, :])
        return calib_batches, test
    except Exception as e:  # no datasets package, no cached corpus, ...
        raise RuntimeError(
            f"dataset {name!r} unavailable (offline?): {e}. "
            "Use eval.datasets.synthetic_tokens for offline testing.") from e
