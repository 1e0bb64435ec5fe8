"""onebit_tpu_torch: OneBit LLaMA serving in PyTorch with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

The PyTorch port of ``onebit_tpu``, which stays the reference. This package
imports torch and numpy, never jax and nothing of ``onebit_tpu``. Importing
it builds and loads no kernel: ``kernels/build.py`` compiles the CUDA
sources at their first launch.

Entry points run on the card unless the caller passes ``device="cpu"``::

    from onebit_tpu_torch import (BitLlamaConfig, ContinuousBatchingEngine,
                                  fuse_for_decode, host_random_packed_params)
    config = BitLlamaConfig.named("llama2-7b")
    params = fuse_for_decode(host_random_packed_params(config, seed=0), config)
    engine = ContinuousBatchingEngine(params, config, max_batch=8, max_len=256)
    uid = engine.add_request([1, 15043, 29892], max_new_tokens=32)
    print(engine.run()[uid])

``quantized_kv=True`` serves from int8 KV pools and ``quantized_kv="int4"``
from nibble-packed int4 pools (half and a quarter of the bf16 cache's
bytes), each decode layer in one fused append+attend kernel.
``paged=True`` (with ``page_size``, ``num_pages``) serves from a pool of KV
pages, bf16 or int8 (``quantized_kv=True``), whose decode attention reads
each row's pages through its page table (kernel B10); ``prefix_cache=True``
shares full prompt pages between requests with the same prefix.
``block_steps=N`` decodes N steps a block, on the card one replayed CUDA
graph, and ``pipeline_blocks=True`` overlaps a block's bookkeeping with
the next block; ``python -m onebit_tpu_torch serve`` serves from stdin or
over HTTP (``engine/server.py``).

Evaluation runs the full-sequence ``forward`` (each unpadded layer's causal
attention in kernel B11 on the card) under ``perplexity`` (windowed, the
reference protocol), ``loglikelihood`` and ``loglikelihood_rolling``;
``load_native`` / ``save_native`` read and write the JAX package's native
checkpoints, and ``python -m onebit_tpu_torch eval --ckpt DIR --tokens
FILE.npy`` prints the perplexity of a token stream.

Batch generation (``generate``) prefills left-padded prompts and decodes
every row at a shared cache index (``decode_step``, ``decode_step_flat``;
on the card each step's attention over the dense cache runs kernel B9);
``python -m onebit_tpu_torch generate --ckpt DIR --prompt 1,2,3`` prints
the new token ids. ``load_reference_checkpoint`` reads the reference's
Hugging Face checkpoints (latent, int8-packed, plain LLaMA) and
``export_reference_int8`` writes its int8 format.

Training distills a BitLlama student from a plain (FP) teacher, as the
reference does: ``build_start_params`` makes the SVID start checkpoint,
``make_train_step`` / ``run_kd`` run KD steps on the student's latent
weights (each unpadded layer's attention in B11 and its backward kernels
B11-dkv and B11-dq on the card), and ``pack_model_params`` packs the result
for serving; ``python -m onebit_tpu_torch build-start-ckpt | train |
convert`` does the same on native checkpoints.
"""

from onebit_tpu_torch.ckpt.hf_reader import load_reference_checkpoint
from onebit_tpu_torch.ckpt.native import (export_reference_int8, load_native,
                                          save_native)
from onebit_tpu_torch.convert import params_from_jax, params_to_numpy
from onebit_tpu_torch.core.build_start import build_start_params
from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
from onebit_tpu_torch.engine.generate import generate
from onebit_tpu_torch.engine.paged import (PagedKVCache, QuantPagedKVCache,
                                           init_paged_kv_cache)
from onebit_tpu_torch.engine.sampler import SamplingConfig
from onebit_tpu_torch.eval.loglikelihood import loglikelihood
from onebit_tpu_torch.eval.ppl import perplexity
from onebit_tpu_torch.eval.rolling import loglikelihood_rolling
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.bitllama import (decode_step, decode_step_flat,
                                             forward, fuse_for_decode,
                                             init_params, pack_model_params)
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.kv_cache import (QuantKVCache, QuantKVCacheKT,
                                             QuantKVCacheKT4,
                                             init_quant_kv_cache,
                                             init_quant_kv_cache_kt,
                                             init_quant_kv_cache_kt4)
from onebit_tpu_torch.train.losses import KDConfig
from onebit_tpu_torch.train.run_kd import KDRunConfig, run_kd
from onebit_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                            make_train_step)
from onebit_tpu_torch.utils.randinit import host_random_packed_params

__all__ = [
    "BitLlamaConfig", "ContinuousBatchingEngine", "KDConfig", "KDRunConfig",
    "LinearWeights", "PagedKVCache", "QuantKVCache", "QuantKVCacheKT",
    "QuantKVCacheKT4", "QuantPagedKVCache", "SamplingConfig", "TrainConfig",
    "build_start_params", "decode_step", "decode_step_flat",
    "export_reference_int8", "forward", "fuse_for_decode", "generate",
    "host_random_packed_params", "init_paged_kv_cache", "init_params",
    "init_quant_kv_cache", "init_quant_kv_cache_kt",
    "init_quant_kv_cache_kt4", "init_train_state", "load_native",
    "load_reference_checkpoint", "loglikelihood", "loglikelihood_rolling",
    "make_train_step",
    "pack_model_params", "params_from_jax", "params_to_numpy", "perplexity",
    "run_kd", "save_native",
]
