"""Port parity: the hub corpus loaders (``get_wikitext2``, ``get_ptb``,
``get_c4``) and ``get_loaders`` over them.

No corpus is downloaded: a stub ``datasets`` module stands in
``sys.modules`` and serves fixed rows for each (path, name, split), and
records every ``load_dataset`` call.  The port's loaders must ask for the
JAX package's datasets, splits and files, and give its test streams and
calibration windows (tolerance: equal ids).  Without ``datasets`` both
raise ``RuntimeError``.  No JAX compiles: the loaders are numpy.
"""

import sys
import types
import zlib

import numpy as np
import pytest

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.eval import datasets as jdata
from micromix_tpu_torch.eval import datasets as tdata


class _Tokenizer:
    """HF-tokenizer stand-in: whitespace words hashed by their bytes."""

    vocab_size = 101

    def __call__(self, text, return_tensors="np"):
        ids = [sum(w.encode()) % self.vocab_size for w in text.split()]
        return {"input_ids": np.asarray([ids], np.int64)}


def _rows(path, split, n):
    """n fixed lines of words, different for each corpus and split."""
    rng = np.random.default_rng(zlib.crc32(f"{path}/{split}".encode()))
    words = [f"w{i}" for i in range(300)]
    return [" ".join(rng.choice(words, int(rng.integers(5, 40))))
            for _ in range(n)]


class _Table(dict):
    """What ``load_dataset`` returns without streaming: columns by name."""


def _stub_datasets(calls):
    mod = types.ModuleType("datasets")

    def load_dataset(path, name=None, split=None, data_files=None,
                     streaming=False):
        calls.append((path, name, split, data_files, streaming))
        if path == "allenai/c4":
            assert streaming and split in data_files
            # more documents than the loader's n_docs reads
            return iter({"text": t, "url": "u"}
                        for t in _rows(path, split, 1200))
        column = {"wikitext": "text", "ptb_text_only": "sentence"}[path]
        return _Table({column: _rows(path, split, 400)})

    mod.load_dataset = load_dataset
    return mod


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "c4"])
def test_hub_loaders_match_jax(monkeypatch, name):
    tok = _Tokenizer()
    got = {}
    for pkg, mod in (("jax", jdata), ("torch", tdata)):
        calls = []
        monkeypatch.setitem(sys.modules, "datasets", _stub_datasets(calls))
        split = "validation" if name == "c4" else "test"
        windows, stream = mod.get_loaders(name, tok, split=split, seqlen=64,
                                          nsamples=5, seed=3)
        direct = {"wikitext2": mod.get_wikitext2, "ptb": mod.get_ptb,
                  "c4": mod.get_c4}[name](tok, split="train")
        got[pkg] = (windows, stream, direct, calls)
    (jw, js, jd, jc), (tw, ts, td, tc) = got["jax"], got["torch"]
    assert tc == jc                       # datasets, splits, files, streaming
    assert len(tc) == 3 and tc[1][2] == "train"
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    assert len(tw) == len(jw) == 5
    for a, b in zip(tw, jw):
        assert a.shape == (1, 64)
        np.testing.assert_array_equal(a, b)
    assert ts.size > 64 and td.size > 64 * 5


def test_hub_loaders_without_datasets_raise(monkeypatch):
    tok = _Tokenizer()
    monkeypatch.setitem(sys.modules, "datasets", None)   # import fails
    for name in ("wikitext2", "ptb", "c4"):
        for mod in (jdata, tdata):
            with pytest.raises(RuntimeError, match="unavailable"):
                mod.get_loaders(name, tok, nsamples=2)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.get_loaders("nope", tok)
