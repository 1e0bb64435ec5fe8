"""LM backends for the task harness beyond the native quantized model.

The reference's eval fork keeps a model registry (lm_eval/models/__init__.py:
hf-causal via huggingface.py:18-44, gpt2 via models_utils.BaseLM, API models,
dummy) so the SAME task battery scores FP16 baselines next to the quantized
model.  Here the harness's ``lm=`` hook (eval/tasks/base.py:_run_requests)
takes any object with the three-method surface; this module provides:

* :class:`TorchCausalLM` — any HuggingFace ``*ForCausalLM`` (e.g. the FP16
  teacher), so the "FP16" columns of the reference's README tables
  reproduce through our harness.
* :class:`TorchSeq2SeqLM` — the hf-seq2seq class (reference
  huggingface.py:421 ``AutoSeq2SeqLM``): encoder-decoder scoring where
  the context feeds the encoder and the continuation is the decoder
  target.
* :class:`NativeLM` — the native model wrapped into the same object
  surface, for code that wants a uniform handle instead of (params,
  config).

API keys / remote backends (reference gpt3.py, textsynth.py) are out of
scope in a zero-egress environment.

Port of ``onebit_tpu/eval/adapters.py``: the two torch adapters are copies
whose ``device`` defaults to ``"cuda"``, as every entry point of the port
does; :class:`NativeLM` stands where the JAX package's ``JaxLM`` does and
wraps the port's ``loglikelihood``, ``loglikelihood_rolling`` and
``greedy_until``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from onebit_tpu_torch.eval.loglikelihood import loglikelihood
from onebit_tpu_torch.eval.rolling import (greedy_until,
                                           loglikelihood_rolling,
                                           rolling_windows)


class TorchCausalLM:
    """The reference's hf-causal adapter (huggingface.py:18-44 +
    models_utils.BaseLM loglikelihood machinery) for torch models.

    Token-level API: requests arrive pre-tokenized from the harness.
    Batches are padded right; continuation logprobs are gathered under
    fp32 log_softmax (reference base.py:294-325).
    """

    def __init__(self, model, *, max_length: int = 2048,
                 batch_size: int = 8, device: str = "cuda"):
        self.model = model.to(device).eval()
        self.device = device
        self.max_length = max_length
        self.batch_size = batch_size

    @classmethod
    def from_pretrained(cls, path: str, **kw):
        from transformers import AutoModelForCausalLM
        model = AutoModelForCausalLM.from_pretrained(path)
        max_len = getattr(model.config, "max_position_embeddings", 2048)
        kw.setdefault("max_length", max_len)
        return cls(model, **kw)

    # -- request API --------------------------------------------------------

    def loglikelihood(self, requests: Sequence[Tuple[Sequence[int],
                                                     Sequence[int]]]
                      ) -> List[Tuple[float, bool]]:
        out: List[Optional[Tuple[float, bool]]] = [None] * len(requests)
        # ranked collation: sort by total length so batches pad minimally
        # (reference base.py:257-292 _collate)
        order = sorted(range(len(requests)),
                       key=lambda i: -(len(requests[i][0])
                                       + len(requests[i][1])))
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            rows, conts = [], []
            for i in idxs:
                ctx, cont = requests[i]
                toks = (list(ctx) + list(cont))[-self.max_length:]
                cont = list(cont)[-self.max_length + 1:] if len(cont) \
                    >= self.max_length else list(cont)
                rows.append(toks)
                conts.append(cont)
            width = max(len(r) for r in rows)
            batch = np.zeros((len(rows), width), np.int64)
            for j, r in enumerate(rows):
                batch[j, :len(r)] = r
            with torch.no_grad():
                logits = self.model(
                    torch.from_numpy(batch).to(self.device)).logits
                logprobs = torch.log_softmax(logits.float(), dim=-1)
            for j, i in enumerate(idxs):
                nc = len(conts[j])
                n = len(rows[j])
                # token t is predicted at position t-1
                lp = logprobs[j, n - nc - 1:n - 1]
                tgt = torch.tensor(conts[j], dtype=torch.long,
                                   device=lp.device)
                tok_lp = lp.gather(-1, tgt[:, None])[:, 0]
                greedy = bool((lp.argmax(-1) == tgt).all())
                out[i] = (float(tok_lp.sum()), greedy)
        return out  # type: ignore[return-value]

    def loglikelihood_rolling(self, documents: Sequence[Sequence[int]]
                              ) -> List[float]:
        results = []
        for doc in documents:
            pairs = rolling_windows(doc, self.max_length - 1)
            scores = self.loglikelihood(pairs)
            results.append(sum(s for s, _ in scores))
        return results

    def greedy_until(self, requests, detokenize=None,
                     max_new_tokens: int = 256) -> List[str]:
        if detokenize is None:
            raise ValueError("greedy_until tasks need a detokenize fn")
        outs = []
        for ctx_toks, stops in requests:
            toks = list(ctx_toks)[-(self.max_length - max_new_tokens):]
            ids = torch.tensor([toks], dtype=torch.long, device=self.device)
            gen: List[int] = []
            with torch.no_grad():
                for _ in range(max_new_tokens):
                    logits = self.model(ids).logits[0, -1]
                    nxt = int(logits.argmax())
                    gen.append(nxt)
                    text = detokenize(gen)
                    if any(s in text for s in stops):
                        break
                    ids = torch.cat(
                        [ids, torch.tensor([[nxt]], device=self.device)],
                        dim=1)[:, -self.max_length:]
            text = detokenize(gen)
            for s in stops:   # truncate at the first stop sequence
                pos = text.find(s)
                if pos >= 0:
                    text = text[:pos]
            outs.append(text)
        return outs


class TorchSeq2SeqLM:
    """The reference's hf-seq2seq adapter (huggingface.py:421-560
    ``AutoSeq2SeqLM``) for encoder-decoder torch models (T5 family).

    Seq2seq scoring semantics (reference loglikelihood, huggingface.py:
    437-465 + _loglikelihood_tokens :516-550): the CONTEXT feeds the
    encoder and the CONTINUATION is the decoder target — ``model(
    input_ids=ctx, labels=cont)`` shifts the labels right internally, so
    decoder logit t predicts cont[t]; the score is the sum of target
    log-softmaxes over the true continuation length and ``is_greedy`` is
    argmax equality.  Rolling loglikelihood scores each window
    independently with the window's prefix as encoder input
    (reference :467-514).  Token-level API like :class:`TorchCausalLM`;
    ``pad_id`` pads both encoder batches (with attention masked) and
    label batches (masked from the score).
    """

    def __init__(self, model, *, max_length: int = 512,
                 batch_size: int = 8, device: str = "cuda",
                 pad_id: int = 0):
        self.model = model.to(device).eval()
        self.device = device
        self.max_length = max_length
        self.batch_size = batch_size
        self.pad_id = pad_id

    @classmethod
    def from_pretrained(cls, path: str, **kw):
        from transformers import AutoModelForSeq2SeqLM
        model = AutoModelForSeq2SeqLM.from_pretrained(path)
        pad = getattr(model.config, "pad_token_id", None)
        kw.setdefault("pad_id", 0 if pad is None else pad)
        return cls(model, **kw)

    # -- request API --------------------------------------------------------

    def loglikelihood(self, requests: Sequence[Tuple[Sequence[int],
                                                     Sequence[int]]]
                      ) -> List[Tuple[float, bool]]:
        out: List[Optional[Tuple[float, bool]]] = [None] * len(requests)
        order = sorted(range(len(requests)),
                       key=lambda i: -(len(requests[i][0])
                                       + len(requests[i][1])))
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            ctxs = [list(requests[i][0])[-self.max_length:] for i in idxs]
            conts = [list(requests[i][1])[:self.max_length] for i in idxs]
            wc = max(len(c) for c in ctxs)
            wk = max(len(c) for c in conts)
            enc = np.full((len(idxs), wc), self.pad_id, np.int64)
            att = np.zeros((len(idxs), wc), np.int64)
            lab = np.full((len(idxs), wk), self.pad_id, np.int64)
            for j, (c, k) in enumerate(zip(ctxs, conts)):
                enc[j, :len(c)] = c
                att[j, :len(c)] = 1
                lab[j, :len(k)] = k
            with torch.no_grad():
                logits = self.model(
                    input_ids=torch.from_numpy(enc).to(self.device),
                    attention_mask=torch.from_numpy(att).to(self.device),
                    labels=torch.from_numpy(lab).to(self.device)).logits
                logprobs = torch.log_softmax(logits.float(), dim=-1)
            for j, i in enumerate(idxs):
                nk = len(conts[j])
                lp = logprobs[j, :nk]
                tgt = torch.tensor(conts[j], dtype=torch.long,
                                   device=lp.device)
                tok_lp = lp.gather(-1, tgt[:, None])[:, 0]
                greedy = bool((lp.argmax(-1) == tgt).all())
                out[i] = (float(tok_lp.sum()), greedy)
        return out  # type: ignore[return-value]

    def loglikelihood_rolling(self, documents: Sequence[Sequence[int]]
                              ) -> List[float]:
        results = []
        for doc in documents:
            pairs = rolling_windows(doc, self.max_length - 1)
            scores = self.loglikelihood(pairs)
            results.append(sum(s for s, _ in scores))
        return results

    def greedy_until(self, requests, detokenize=None,
                     max_new_tokens: int = 256) -> List[str]:
        if detokenize is None:
            raise ValueError("greedy_until tasks need a detokenize fn")
        outs = []
        for ctx_toks, stops in requests:
            toks = list(ctx_toks)[-self.max_length:]
            ids = torch.tensor([toks], dtype=torch.long, device=self.device)
            with torch.no_grad():
                gen = self.model.generate(input_ids=ids, do_sample=False,
                                          max_new_tokens=max_new_tokens)
            # generate() output for seq2seq is decoder-only tokens,
            # starting at decoder_start_token; drop it + trailing pads
            gen_toks = [int(t) for t in gen[0][1:] if int(t) != self.pad_id]
            text = detokenize(gen_toks)
            for s in stops:
                pos = text.find(s)
                if pos >= 0:
                    text = text[:pos]
            outs.append(text)
        return outs


class NativeLM:
    """The native model behind the same three-method surface, so callers
    can treat quantized/native and torch baselines uniformly. Its calls
    are those ``evaluate_tasks`` makes without ``lm=``: the same params,
    batch size, ``impl`` and dtype give the same results."""

    def __init__(self, params, config, *, batch_size: int = 16,
                 impl: str = "auto", compute_dtype=None):
        self.params = params
        self.config = config
        self.batch_size = batch_size
        self.impl = impl
        self.compute_dtype = compute_dtype or torch.float32

    @torch.no_grad()
    def loglikelihood(self, requests):
        return loglikelihood(self.params, self.config, requests,
                             batch_size=self.batch_size, impl=self.impl,
                             compute_dtype=self.compute_dtype,
                             max_length=self.config.max_position_embeddings)

    @torch.no_grad()
    def loglikelihood_rolling(self, documents):
        return loglikelihood_rolling(
            self.params, self.config, documents,
            batch_size=self.batch_size, compute_dtype=self.compute_dtype,
            max_length=self.config.max_position_embeddings, impl=self.impl)

    @torch.no_grad()
    def greedy_until(self, requests, detokenize=None,
                     max_new_tokens: int = 256):
        if detokenize is None:
            raise ValueError("greedy_until tasks need a detokenize fn")
        return greedy_until(self.params, self.config, requests, detokenize,
                            max_new_tokens=max_new_tokens,
                            batch_size=self.batch_size, impl=self.impl)
