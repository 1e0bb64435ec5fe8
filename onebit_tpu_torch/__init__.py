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
"""

from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
from onebit_tpu_torch.engine.sampler import SamplingConfig
from onebit_tpu_torch.model.bitllama import fuse_for_decode
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.model.kv_cache import (QuantKVCache, QuantKVCacheKT,
                                             QuantKVCacheKT4,
                                             init_quant_kv_cache,
                                             init_quant_kv_cache_kt,
                                             init_quant_kv_cache_kt4)
from onebit_tpu_torch.utils.randinit import host_random_packed_params

__all__ = [
    "BitLlamaConfig", "ContinuousBatchingEngine", "QuantKVCache",
    "QuantKVCacheKT", "QuantKVCacheKT4", "SamplingConfig", "fuse_for_decode",
    "host_random_packed_params", "init_quant_kv_cache",
    "init_quant_kv_cache_kt", "init_quant_kv_cache_kt4", "params_from_jax",
]
