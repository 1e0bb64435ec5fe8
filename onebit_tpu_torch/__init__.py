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

Evaluation runs the full-sequence ``forward`` (each unpadded layer's causal
attention in kernel B11 on the card) under ``perplexity`` (windowed, the
reference protocol), ``loglikelihood`` and ``loglikelihood_rolling``;
``load_native`` / ``save_native`` read and write the JAX package's native
checkpoints, and ``python -m onebit_tpu_torch eval --ckpt DIR --tokens
FILE.npy`` prints the perplexity of a token stream.
"""

from onebit_tpu_torch.ckpt.native import load_native, save_native
from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
from onebit_tpu_torch.engine.paged import (PagedKVCache, QuantPagedKVCache,
                                           init_paged_kv_cache)
from onebit_tpu_torch.engine.sampler import SamplingConfig
from onebit_tpu_torch.eval.loglikelihood import loglikelihood
from onebit_tpu_torch.eval.ppl import perplexity
from onebit_tpu_torch.eval.rolling import loglikelihood_rolling
from onebit_tpu_torch.kernels.linear import LinearWeights
from onebit_tpu_torch.model.bitllama import forward, fuse_for_decode
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.kv_cache import (QuantKVCache, QuantKVCacheKT,
                                             QuantKVCacheKT4,
                                             init_quant_kv_cache,
                                             init_quant_kv_cache_kt,
                                             init_quant_kv_cache_kt4)
from onebit_tpu_torch.utils.randinit import host_random_packed_params

__all__ = [
    "BitLlamaConfig", "ContinuousBatchingEngine", "LinearWeights",
    "PagedKVCache", "QuantKVCache", "QuantKVCacheKT", "QuantKVCacheKT4",
    "QuantPagedKVCache", "SamplingConfig", "forward", "fuse_for_decode",
    "host_random_packed_params", "init_paged_kv_cache", "init_quant_kv_cache",
    "init_quant_kv_cache_kt", "init_quant_kv_cache_kt4", "load_native",
    "loglikelihood", "loglikelihood_rolling", "params_from_jax", "perplexity",
    "save_native",
]
