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
"""

from onebit_tpu_torch.convert import params_from_jax
from onebit_tpu_torch.engine.batching import ContinuousBatchingEngine
from onebit_tpu_torch.engine.sampler import SamplingConfig
from onebit_tpu_torch.model.bitllama import fuse_for_decode
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.utils.randinit import host_random_packed_params

__all__ = [
    "BitLlamaConfig", "ContinuousBatchingEngine", "SamplingConfig",
    "fuse_for_decode", "host_random_packed_params", "params_from_jax",
]
