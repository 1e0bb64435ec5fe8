"""WikiText rolling perplexity (reference tasks/wikitext.py +
base.PerplexityTask).

Port of ``onebit_tpu/eval/tasks/wikitext.py``: per document, the total
loglikelihood from rolling windows (every token scored once), aggregated
over the corpus as

    word_perplexity = exp(-sum ll / sum words)
    byte_perplexity = exp(-sum ll / sum bytes)
    bits_per_byte   = -sum ll / (sum bytes * ln 2)

with the reference's WikiText detokenizer (``wikitext_detokenize``, copied
from the JAX package) applied to each page before tokenization. The caller
passes ``tokenize``: the command line's ``--wikitext`` waits for a tokenizer
in the repository.
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence

from onebit_tpu_torch.eval.rolling import loglikelihood_rolling


def wikitext_detokenize(string: str) -> str:
    """Standard WikiText detokenizer (moses-style, undoes @-@ markup)."""
    string = string.replace("s '", "s'")
    string = re.sub(r"/' [0-9]/", r"/'[0-9]/", string)
    string = string.replace(" @-@ ", "-")
    string = string.replace(" @,@ ", ",")
    string = string.replace(" @.@ ", ".")
    string = string.replace(" : ", ": ")
    string = string.replace(" ; ", "; ")
    string = string.replace(" . ", ". ")
    string = string.replace(" ! ", "! ")
    string = string.replace(" ? ", "? ")
    string = string.replace(" , ", ", ")
    string = re.sub(r"\(\s*([^\)]*?)\s*\)", r"(\1)", string)
    string = re.sub(r"\[\s*([^\]]*?)\s*\]", r"[\1]", string)
    string = re.sub(r"{\s*([^}]*?)\s*}", r"{\1}", string)
    string = re.sub(r"\"\s*([^\"]*?)\s*\"", r'"\1"', string)
    string = re.sub(r"'\s*([^']*?)\s*'", r"'\1'", string)
    string = string.replace("= = = =", "====")
    string = string.replace("= = =", "===")
    string = string.replace("= =", "==")
    string = string.replace(" " + chr(176) + " ", chr(176))
    string = string.replace(" \n", "\n")
    string = string.replace("\n ", "\n")
    string = string.replace(" N ", " 1 ")
    string = string.replace(" 's", "'s")
    return string


def evaluate_wikitext(params, config, pages: Sequence[str], tokenize, *,
                      batch_size: int = 8, max_length=None,
                      compute_dtype=None, detokenize_pages: bool = True):
    """pages -> {word_perplexity, byte_perplexity, bits_per_byte}."""
    docs = [wikitext_detokenize(p) if detokenize_pages else p
            for p in pages]
    docs = [d for d in docs if d.strip()]
    token_docs: List[List[int]] = [list(tokenize(d)) for d in docs]
    lls = loglikelihood_rolling(params, config, token_docs,
                                max_length=max_length,
                                batch_size=batch_size,
                                compute_dtype=compute_dtype)
    total_ll = sum(lls)
    words = sum(len(re.split(r"\s+", d)) for d in docs)
    bytes_ = sum(len(d.encode("utf-8")) for d in docs)
    return {
        "word_perplexity": math.exp(-total_ll / max(words, 1)),
        "byte_perplexity": math.exp(-total_ll / max(bytes_, 1)),
        "bits_per_byte": -total_ll / (max(bytes_, 1) * math.log(2)),
    }
