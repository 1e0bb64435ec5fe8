"""The port's LM adapters (``onebit_tpu_torch/eval/adapters.py``) against
the JAX package's on the CPU.

``TorchCausalLM`` and ``TorchSeq2SeqLM`` on a tiny ``LlamaForCausalLM`` and
a tiny ``T5ForConditionalGeneration``, built from configs here as
tests/test_adapters.py builds them (nothing is downloaded): the same
log-likelihoods, greedy flags, rolling sums and greedy texts as JAX's
copies, and the same ``evaluate_tasks`` results through ``lm=``.
``NativeLM`` on the tiny BitLlama (JAX packed params carried over by
``params_from_jax``) in fp32: each log-likelihood within 1e-4 of
``JaxLM``'s, the same greedy flags and texts.
"""

import functools
import inspect
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from onebit_tpu.engine import generate as jgenerate  # noqa: E402
from onebit_tpu.eval import adapters as jad  # noqa: E402
from onebit_tpu.eval.tasks import base as jbase  # noqa: E402
from onebit_tpu.eval.tasks import suite as jsuite  # noqa: E402
from onebit_tpu.model import bitllama as jb  # noqa: E402
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig  # noqa: E402
from onebit_tpu_torch import params_from_jax  # noqa: E402
from onebit_tpu_torch.eval import adapters as tad  # noqa: E402
from onebit_tpu_torch.eval import rolling as trolling  # noqa: E402
from onebit_tpu_torch.eval.tasks import base as tbase  # noqa: E402
from onebit_tpu_torch.eval.tasks import suite as tsuite  # noqa: E402
from onebit_tpu_torch.model.config import BitLlamaConfig  # noqa: E402

LL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one torch thread each, beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _requests(seed, vocab, n=7, lo=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(lo, vocab, int(rng.integers(2, 9))).tolist(),
             rng.integers(lo, vocab, int(rng.integers(1, 5))).tolist())
            for _ in range(n)]


def _detok(toks):
    return " ".join(f"t{t}" for t in toks)


@pytest.fixture(scope="module")
def causal():
    from transformers import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=97, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=64)
    torch.manual_seed(0)
    return LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def seq2seq():
    from transformers import T5Config, T5ForConditionalGeneration
    cfg = T5Config(vocab_size=97, d_model=32, d_ff=64, d_kv=8,
                   num_layers=2, num_decoder_layers=2, num_heads=4,
                   decoder_start_token_id=0, pad_token_id=0)
    torch.manual_seed(0)
    return T5ForConditionalGeneration(cfg).eval()


def test_torch_adapters_default_to_the_card():
    for cls in (tad.TorchCausalLM, tad.TorchSeq2SeqLM):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.mark.parametrize("kind", ["causal", "seq2seq"])
def test_torch_adapter_matches_jax(kind, causal, seq2seq):
    """Log-likelihoods (a ragged last batch), a rolling sum over several
    windows and greedy texts, cut at a stop: each equal to the JAX
    package's adapter on the same model."""
    model = causal if kind == "causal" else seq2seq
    name = "TorchCausalLM" if kind == "causal" else "TorchSeq2SeqLM"
    tl = getattr(tad, name)(model, max_length=16, batch_size=3,
                            device="cpu")
    jl = getattr(jad, name)(model, max_length=16, batch_size=3)
    reqs = _requests(1, 97)
    assert tl.loglikelihood(reqs) == jl.loglikelihood(reqs)
    docs = [list(range(1, 40)), list(range(5, 12))]
    assert tl.loglikelihood_rolling(docs) == jl.loglikelihood_rolling(docs)
    gen = [([1, 2, 3], ["NEVER"]), ([4, 5], ["t"]), ([7, 8, 9], ["3"])]
    got = tl.greedy_until(gen, detokenize=_detok, max_new_tokens=4)
    assert got == jl.greedy_until(gen, detokenize=_detok, max_new_tokens=4)
    assert got[1] == ""       # the stop is the first generated text
    with pytest.raises(ValueError, match="detokenize"):
        tl.greedy_until(gen)


def test_torch_adapter_through_the_harness(causal):
    """``evaluate_tasks(..., lm=TorchCausalLM(...))`` on PIQA gives JAX's
    dict, stderrs included."""
    docs = [{"goal": f"goal {i}", "sol1": "yes", "sol2": "no",
             "label": i % 2} for i in range(6)]

    def tokenize(s):
        return [(ord(c) % 96) + 1 for c in s][:30]
    got = tbase.evaluate_tasks(
        None, None, [tsuite.PIQA(docs)], tokenize, batch_size=2,
        lm=tad.TorchCausalLM(causal, max_length=64, device="cpu"))
    want = jbase.evaluate_tasks(
        None, None, [jsuite.PIQA(docs)], tokenize, batch_size=2,
        lm=jad.TorchCausalLM(causal, max_length=64))
    assert got == want and "acc_stderr" in got["piqa"]


@pytest.fixture(scope="module")
def tiny():
    jc = JaxConfig.named("tiny")
    jp = jb.pack_model_params(jb.init_params(jc, jax.random.PRNGKey(8)))
    c = BitLlamaConfig.named("tiny")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), c, device="cpu")
    return jc, jp, c, tp


def test_native_lm_matches_jax_lm(tiny, monkeypatch):
    """``NativeLM`` against ``JaxLM`` on the tiny model in fp32 (both
    generate in fp32 here, as tests/test_torch_tasks.py has them do):
    log-likelihoods within 1e-4 with the same greedy flags, rolling sums
    within 1e-4 relative, the same greedy texts."""
    jc, jp, c, tp = tiny
    monkeypatch.setattr(jgenerate, "generate", functools.partial(
        jgenerate.generate, compute_dtype=jnp.float32))
    monkeypatch.setattr(trolling, "generate", functools.partial(
        trolling.generate, compute_dtype=torch.float32))
    tl = tad.NativeLM(tp, c, batch_size=4, compute_dtype=torch.float32)
    jl = jad.JaxLM(jp, jc, batch_size=4)
    reqs = _requests(2, c.vocab_size, n=9)
    got, want = tl.loglikelihood(reqs), jl.loglikelihood(reqs)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LL_TOL, atol=LL_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]
    rng = np.random.default_rng(3)
    docs = [rng.integers(1, c.vocab_size, n).tolist() for n in (40, 130)]
    np.testing.assert_allclose(tl.loglikelihood_rolling(docs),
                               jl.loglikelihood_rolling(docs), rtol=LL_TOL)
    gen = [(r[0], ["\n", "t1"]) for r in reqs[:5]]
    assert tl.greedy_until(gen, detokenize=_detok, max_new_tokens=5) == \
        jl.greedy_until(gen, detokenize=_detok, max_new_tokens=5)
