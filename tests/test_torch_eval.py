"""The port's evaluation (``onebit_tpu_torch/eval/``) against the JAX
package's at the tiny config in fp32, on JAX packed params carried over by
``params_from_jax``.

Tolerances: perplexity to 1e-5 relative (tests/test_eval.py's own bound
between the direct and the vocab-chunked CE); log-likelihoods to 1e-4 with
equal greedy flags (tests/test_eval.py's bound against per-request
scoring). Logits agree to 2e-4 (tests/test_torch_forward.py), and the
random weights' top-2 logits lie far further apart than that here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.eval.loglikelihood import loglikelihood as jll
from onebit_tpu.eval.ppl import perplexity as jppl
from onebit_tpu.eval.rolling import greedy_until as jgreedy_until
from onebit_tpu.eval.rolling import loglikelihood_rolling as jroll
from onebit_tpu.eval.rolling import rolling_windows as jwindows
from onebit_tpu.eval.tasks.wikitext import evaluate_wikitext as jwiki
from onebit_tpu.eval.tasks.wikitext import wikitext_detokenize as jdetok
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (loglikelihood, loglikelihood_rolling,
                              params_from_jax, perplexity)
from onebit_tpu_torch.eval import ppl as tppl
from onebit_tpu_torch.eval.loglikelihood import _bucket_len
from onebit_tpu_torch.eval.rolling import greedy_until, rolling_windows
from onebit_tpu_torch.eval.tasks.wikitext import (evaluate_wikitext,
                                                  wikitext_detokenize)
from onebit_tpu_torch.model.config import BitLlamaConfig


@pytest.fixture(scope="module")
def tiny():
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(3)))
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return jc, jp, c, tp


def _tokens(c, n, seed):
    return np.random.default_rng(seed).integers(0, c.vocab_size, n)


@pytest.mark.parametrize("vocab_chunk", [None, 128, 200, 512],
                         ids=["direct", "chunk128", "chunk200", "chunkV"])
def test_perplexity_matches_jax(tiny, vocab_chunk):
    """5 windows of 32 at batch 2: the last batch is zero-padded and its
    pad row dropped; 200 does not divide V = 512."""
    jc, jp, c, tp = tiny
    tokens = _tokens(c, 5 * 32 + 7, seed=1)
    want = jppl(jp, jc, tokens, seqlen=32, batch_size=2,
                vocab_chunk=vocab_chunk)
    got = perplexity(tp, c, tokens, seqlen=32, batch_size=2,
                     vocab_chunk=vocab_chunk)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_perplexity_chunked_equals_direct_per_window(tiny):
    _, _, c, tp = tiny
    tokens = _tokens(c, 4 * 32, seed=2)
    direct = tppl.window_nlls(tp, c, tokens, seqlen=32, batch_size=3)
    chunked = tppl.window_nlls(tp, c, tokens, seqlen=32, batch_size=3,
                               vocab_chunk=200)
    assert direct.shape == (4,)
    np.testing.assert_allclose(chunked, direct, rtol=1e-5)
    assert tppl.ppl_from_nlls(direct, 32) == perplexity(
        tp, c, tokens, seqlen=32, batch_size=3)


@pytest.mark.parametrize("vocab_chunk", [None, 200])
def test_perplexity_uniform_model(tiny, vocab_chunk):
    """A zeroed lm_head gives uniform logits: ppl == vocab_size."""
    _, _, c, tp = tiny
    uniform = dict(tp, lm_head=torch.zeros_like(tp["lm_head"]))
    ppl = perplexity(uniform, c, _tokens(c, 4 * 64, seed=3), seqlen=64,
                     batch_size=2, vocab_chunk=vocab_chunk)
    np.testing.assert_allclose(ppl, c.vocab_size, rtol=1e-4)


def test_perplexity_limit_and_short_stream(tiny):
    jc, jp, c, tp = tiny
    tokens = _tokens(c, 8 * 32, seed=4)
    a = perplexity(tp, c, tokens[:2 * 32], seqlen=32)
    b = perplexity(tp, c, tokens, seqlen=32, limit=2)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(b, jppl(jp, jc, tokens, seqlen=32, limit=2),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="too short"):
        perplexity(tp, c, tokens[:31], seqlen=32)


def _requests(c, n, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        nc, nk = int(rng.integers(0, 90)), int(rng.integers(1, 6))
        reqs.append((rng.integers(0, c.vocab_size, nc).tolist(),
                     rng.integers(0, c.vocab_size, nk).tolist()))
    return reqs


def _greedy_requests(c, tp, n, seed):
    """Requests whose one-token continuation is the port's own greedy
    token, so that both flag values occur."""
    from onebit_tpu_torch.model.bitllama import forward
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        ctx = rng.integers(0, c.vocab_size, int(rng.integers(1, 40)))
        logits = forward(tp, torch.from_numpy(ctx)[None], c,
                         compute_dtype=torch.float32)
        reqs.append((ctx.tolist(), [int(logits[0, -1].argmax())]))
    return reqs


def test_loglikelihood_matches_jax(tiny):
    """Buckets of 64 and 128, an empty context, a request truncated to
    max_length, a batch with pad rows."""
    jc, jp, c, tp = tiny
    reqs = _requests(c, 9, seed=5) + _greedy_requests(c, tp, 3, seed=6)
    reqs[0] = ([], reqs[0][1])
    reqs[1] = (_tokens(c, 150, seed=7).tolist(), [1, 2, 3])
    want = jll(jp, jc, reqs, batch_size=5, max_length=120)
    got = loglikelihood(tp, c, reqs, batch_size=5, max_length=120)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4, atol=1e-4)
    assert [g[1] for g in got] == [w[1] for w in want]
    assert sum(g[1] for g in got) >= 3          # both flag values occur
    with pytest.raises(ValueError, match="empty continuation"):
        loglikelihood(tp, c, [([1], [])])


def test_bucket_len():
    assert [_bucket_len(n) for n in (1, 64, 65, 128, 129, 2048)] == \
        [64, 64, 128, 128, 256, 2048]


def test_rolling_matches_jax(tiny):
    jc, jp, c, tp = tiny
    docs = [_tokens(c, n, seed=n).tolist() for n in (5, 70, 131)]
    for doc in docs:
        assert rolling_windows(doc, 64, 0) == jwindows(doc, 64, 0)
    want = jroll(jp, jc, docs, max_length=64, batch_size=4)
    got = loglikelihood_rolling(tp, c, docs, max_length=64, batch_size=4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    requests = [([1, 2], ["\n"]), (docs[1][:9], ["c"])]

    def detok(toks):
        return "".join(chr(ord("a") + t % 26) for t in toks)
    want = jgreedy_until(jp, jc, requests, detok, max_new_tokens=5)
    assert greedy_until(tp, c, requests, detok, max_new_tokens=5) == want


def test_wikitext_matches_jax(tiny):
    """A toy byte tokenizer: each UTF-8 byte a token."""
    jc, jp, c, tp = tiny
    pages = [" = Title = \n The cat @-@ like animal ( sat ) here . \n",
             "   ", " It 's 3 @.@ 5 km , \" quoted \" [ a ] . \n"]
    for p in pages:
        assert wikitext_detokenize(p) == jdetok(p)

    def tokenize(s):
        return list(s.encode("utf-8"))

    want = jwiki(jp, jc, pages, tokenize, batch_size=4, max_length=32)
    got = evaluate_wikitext(tp, c, pages, tokenize, batch_size=4,
                            max_length=32)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
