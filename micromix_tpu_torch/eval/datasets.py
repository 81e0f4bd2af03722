"""Dataset loaders for calibration and evaluation.

Counterpart of ``micromix_tpu/eval/datasets.py`` for the loaders that
need no download: ``synthetic_tokens`` (a numpy copy: the same stream for
the same seed) and a local text file (``file:<path>``).  The hub datasets
(wikitext2, ptb, c4) are not loaded: they need files this repository does
not hold.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

HUB_DATASETS = ("wikitext2", "ptb", "c4")


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
    if name in HUB_DATASETS:
        raise RuntimeError(
            f"dataset {name!r} needs a download, which this port does not "
            "make; use 'synthetic' or 'file:<path>' (a local text file)")
    if not name.startswith("file:"):
        raise ValueError(f"unknown dataset {name!r}; one of "
                         f"{list(HUB_DATASETS) + ['synthetic', 'file:<path>']}")
    path = name[len("file:"):]
    test = get_textfile(tokenizer, path, split=split)
    calib_batches: List[np.ndarray] = []
    if nsamples:
        train = get_textfile(tokenizer, path, split="train")
        rng = np.random.default_rng(seed)
        for _ in range(nsamples):
            i = rng.integers(0, len(train) - seqlen - 1)
            calib_batches.append(train[i:i + seqlen][None, :])
    return calib_batches, test
