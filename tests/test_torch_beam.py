"""Beam search in the port against the JAX package, in fp32 with one torch
thread, on a small random model (vocab 32, EOS 1, so that hypotheses
retire into the finished set).

``beam_generate`` is held to JAX's once: sequences exact, scores to 1e-4
(the log-probabilities of two summation orders, summed over six steps).
Port only: one beam is greedy decoding, and the ``generate --num-beams``
command line prints ``beam_generate``'s best sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.engine.beam import beam_generate as jax_beam
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu_torch import (BitLlamaConfig, SamplingConfig, generate,
                              params_from_jax, save_native)
from onebit_tpu_torch.cli import main as port_main
from onebit_tpu_torch.engine.beam import beam_generate

GEOMETRY = dict(vocab_size=32, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=2, max_position_embeddings=64,
                eos_token_id=1)
PROMPTS = [[5, 9, 3], [7, 2, 11, 4, 6]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jc = JaxConfig(**GEOMETRY)
    jp = jb.init_params(jc, jax.random.PRNGKey(7), mode="packed")
    c = BitLlamaConfig(**GEOMETRY)
    return jc, jp, c, params_from_jax(jax.tree.map(np.asarray, jp), c,
                                      device="cpu")


def test_beam_generate_matches_jax(tiny):
    """4 beams, 6 new tokens, length penalty 0.7, all four hypotheses of
    each prompt: JAX's sequences and scores; at least one hypothesis ended
    at EOS, so the finished set is exercised."""
    jc, jp, c, tp = tiny
    kw = dict(num_beams=4, max_new_tokens=6, length_penalty=0.7,
              num_return_sequences=4)
    want = jax_beam(jp, jc, PROMPTS, compute_dtype=jnp.float32, impl="xla",
                    **kw)
    got = beam_generate(tp, c, PROMPTS, compute_dtype=torch.float32, **kw)
    for g_row, w_row in zip(got, want):
        assert [s for s, _ in g_row] == [s for s, _ in w_row]
        np.testing.assert_allclose([x for _, x in g_row],
                                   [x for _, x in w_row], rtol=1e-4,
                                   atol=1e-4)
    assert any(s[-1] == 1 and len(s) < 6 for row in got for s, _ in row)


def test_one_beam_is_greedy(tiny):
    """num_beams=1 with no EOS and no length penalty is greedy decoding."""
    _, _, c, tp = tiny
    greedy = generate(tp, c, PROMPTS, max_new_tokens=6, eos_id=-1,
                      sampling=SamplingConfig(greedy=True),
                      compute_dtype=torch.float32)
    beams = beam_generate(tp, c, PROMPTS, num_beams=1, max_new_tokens=6,
                          eos_id=-1, length_penalty=0.0,
                          compute_dtype=torch.float32)
    assert [b[0][0] for b in beams] == greedy


def test_beam_arguments_refused_as_in_jax(tiny):
    _, _, c, tp = tiny
    with pytest.raises(ValueError, match="num_return_sequences"):
        beam_generate(tp, c, PROMPTS, num_beams=2, num_return_sequences=3)
    with pytest.raises(ValueError, match="exceeds max_len"):
        beam_generate(tp, c, PROMPTS, max_new_tokens=60, max_len=32)


def test_generate_num_beams_cli(tiny, tmp_path, capsys):
    """``generate --num-beams 2 --length-penalty 0.5`` prints the best
    beam of beam_generate on the checkpoint (bf16, as the command runs)."""
    _, _, c, tp = tiny
    save_native(str(tmp_path), c, tp)
    capsys.readouterr()
    port_main(["generate", "--ckpt", str(tmp_path), "--prompt", "5,9,3",
               "--num-beams", "2", "--length-penalty", "0.5",
               "--max-new-tokens", "5", "--device", "cpu"])
    got = [int(t) for t in capsys.readouterr().out.strip().split(",")]
    want = beam_generate(tp, c, [[5, 9, 3]], num_beams=2, max_new_tokens=5,
                         length_penalty=0.5)[0][0][0]
    assert got == want
